"""Fault tolerance of a long run (counterpart of
``repro/train/fault_tolerance.py``, the same behaviour).

* ``StepWatchdog``: a rolling median of step times; a step over
  ``factor`` × the median is a straggler event, passed to a callback, and
  after ``max_consecutive`` of them in a row it raises ``StragglerEvent``.
* ``retry``: bounded exponential-backoff retry of transient errors
  (flaky storage).
* ``PreemptionGuard``: a SIGTERM handler that flips a flag the train loop
  polls to write a final checkpoint before it exits.
* ``Heartbeat``: liveness lines on an interval, for a supervisor.
"""
from __future__ import annotations

import signal
import statistics
import time
from typing import Callable, List, Optional


class StragglerEvent(RuntimeError):
    pass


class StepWatchdog:
    def __init__(self, factor: float = 3.0, window: int = 50,
                 min_samples: int = 5, max_consecutive: int = 0,
                 on_straggler: Optional[Callable[[int, float, float], None]] = None):
        self.factor = factor
        self.window = window
        self.min_samples = min_samples
        self.max_consecutive = max_consecutive  # 0 = never raise
        self.on_straggler = on_straggler
        self.times: List[float] = []
        self.events: List[dict] = []
        self._consecutive = 0

    def median(self) -> float:
        return statistics.median(self.times) if self.times else 0.0

    def observe(self, step: int, dt: float) -> bool:
        """Record a step time; True if it was flagged a straggler."""
        flagged = False
        if len(self.times) >= self.min_samples:
            med = self.median()
            if dt > self.factor * med:
                flagged = True
                self.events.append({"step": step, "dt": dt, "median": med})
                self._consecutive += 1
                if self.on_straggler:
                    self.on_straggler(step, dt, med)
                if self.max_consecutive and \
                        self._consecutive >= self.max_consecutive:
                    raise StragglerEvent(
                        f"{self._consecutive} consecutive straggler steps "
                        f"(last {dt:.3f}s vs median {med:.3f}s)")
        if not flagged:
            self._consecutive = 0
        self.times.append(dt)
        if len(self.times) > self.window:
            self.times.pop(0)
        return flagged


def retry(fn: Callable, *args, attempts: int = 3, base_delay: float = 0.5,
          exceptions=(IOError, OSError), on_retry=None, **kwargs):
    """``fn(*args, **kwargs)``, called again after base_delay · 2^i seconds
    on one of ``exceptions``, at most ``attempts`` times; the last failure
    is raised."""
    for i in range(attempts):
        try:
            return fn(*args, **kwargs)
        except exceptions as e:
            if i == attempts - 1:
                raise
            if on_retry:
                on_retry(i, e)
            time.sleep(base_delay * (2 ** i))


class PreemptionGuard:
    """Flips ``requested`` on SIGTERM (or the ``signals`` given); as a
    context manager it restores the previous handlers on exit."""

    def __init__(self, signals=(signal.SIGTERM,)):
        self.signals = signals
        self.requested = False
        self._prev = {}

    def _handler(self, signum, frame):
        self.requested = True

    def __enter__(self):
        for s in self.signals:
            self._prev[s] = signal.signal(s, self._handler)
        return self

    def __exit__(self, *exc):
        for s, h in self._prev.items():
            signal.signal(s, h)
        return False


class Heartbeat:
    def __init__(self, interval: float = 30.0,
                 emit: Callable[[str], None] = print):
        self.interval = interval
        self.emit = emit
        self._last = 0.0

    def beat(self, step: int, extra: str = ""):
        now = time.monotonic()
        if now - self._last >= self.interval:
            self._last = now
            self.emit(f"[heartbeat] step={step} t={time.time():.0f} {extra}")
