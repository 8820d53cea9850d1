"""Deterministic fault injection for the serving decode path (counterpart of
``repro/serve/faults.py``).

Production decode fails in two characteristic ways: *corrupt output* (a
flipped HBM bit or a bad cache row yields NaN/inf logits for one
sequence) and *transient errors* (a preempted device, a flaky
interconnect — the decode call raises and a retry succeeds). The
batcher's handling of both is a robustness contract, so the injector
makes them reproducible: faults fire on an explicit per-step schedule
(or a seeded random one), never on wall clock, so a failing test replays
bit-for-bit.

The batcher calls ``before_decode(step, attempt)`` immediately before
each decode attempt (may raise ``TransientDecodeError``) and
``corrupt_logits(step, logits)`` on the decode's output (may poison
per-slot rows with NaN/inf). Scheduled transient errors fire ONCE per
step by default — the batcher's in-step retry then succeeds, which is
what "transient" means; ``persistent_errors=True`` makes every attempt
at a scheduled step raise, exercising the retry-budget exhaustion path.
"""
from __future__ import annotations

import math
import random
from typing import Dict, Iterable, List, Mapping, Sequence, Tuple


class TransientDecodeError(RuntimeError):
    """A decode attempt failed in a (presumed) recoverable way."""


class FaultInjector:
    """Deterministic per-step fault schedule.

    ``nan_steps``: {scheduler step: slot indices} whose logits rows are
    overwritten with ``corrupt_value`` after the decode at that step.
    ``error_steps``: scheduler steps whose decode attempt raises
    ``TransientDecodeError`` (once per step unless ``persistent_errors``).
    ``fired`` records every injection actually delivered, in order."""

    def __init__(self, nan_steps: Mapping[int, Sequence[int]] | None = None,
                 error_steps: Iterable[int] | None = None, *,
                 corrupt_value: float = math.nan,
                 persistent_errors: bool = False):
        self.nan_steps: Dict[int, Tuple[int, ...]] = {
            int(s): tuple(slots) for s, slots in (nan_steps or {}).items()}
        self._error_steps = set(int(s) for s in (error_steps or ()))
        self.corrupt_value = corrupt_value
        self.persistent_errors = persistent_errors
        self.fired: List[tuple] = []

    @classmethod
    def seeded(cls, seed: int, steps: int, slots: int, *,
               nan_rate: float = 0.0, error_rate: float = 0.0,
               corrupt_value: float = math.nan,
               persistent_errors: bool = False) -> "FaultInjector":
        """Random-but-reproducible schedule over ``steps`` scheduler steps:
        each step independently corrupts one random slot with probability
        ``nan_rate`` and raises with probability ``error_rate``. Same seed
        → same schedule, on any platform (stdlib ``random``)."""
        rng = random.Random(seed)
        nan_steps: Dict[int, Tuple[int, ...]] = {}
        error_steps = set()
        for s in range(steps):
            if nan_rate and rng.random() < nan_rate:
                nan_steps[s] = (rng.randrange(slots),)
            if error_rate and rng.random() < error_rate:
                error_steps.add(s)
        return cls(nan_steps, error_steps, corrupt_value=corrupt_value,
                   persistent_errors=persistent_errors)

    def before_decode(self, step: int, attempt: int = 0) -> None:
        """Raise if a transient error is scheduled for ``step``. One-shot
        per step (the retry models the transient clearing) unless
        ``persistent_errors``."""
        if step in self._error_steps:
            if not self.persistent_errors:
                self._error_steps.discard(step)
            self.fired.append(("error", step, attempt))
            raise TransientDecodeError(
                f"injected transient decode error at step {step} "
                f"(attempt {attempt})")

    def corrupt_logits(self, step: int, logits):
        """Overwrite the scheduled slots' rows of the (S, V) tensor
        ``logits`` IN PLACE with ``corrupt_value`` (NaN by default; pass
        ``math.inf`` for the overflow flavor) and return it (the reference
        returns an updated copy). Non-scheduled steps pass through
        untouched."""
        slots = self.nan_steps.get(step)
        if not slots:
            return logits
        self.fired.append(("nan", step, slots))
        for i in slots:
            logits[i] = self.corrupt_value
        return logits
