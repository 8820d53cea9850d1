"""Load→precision policy for AdaBits-style degraded serving (counterpart of
``repro/serve/policy.py``; plain Python, the port keeps its own copy).

AdaBits (1912.09666) shows one set of trained weights can serve multiple
bit-widths; the AdaPT controller already owns per-layer ⟨WL,FL⟩ state, so
overload can be answered by *degrading precision* instead of shedding
load. This module maps observed queue pressure to a word length from a
fixed ladder; the batcher pre-materializes one quantized word set per
level (``serve/engine.quantize_serving_levels``) and swaps the active
tree between decode steps — the same tree of the same leaf shapes and
dtypes, so on the card each level has its captured decode graph and a swap
never captures again.

The controller is a plain hysteresis state machine, deliberately free of
wall-clock reads: it is driven once per scheduler step with (queue depth,
p95 queue wait) and requires ``patience`` CONSECUTIVE pressure
observations to step down one level and ``patience`` consecutive drain
observations to step up one level. Mixed observations reset both
counters. Levels are walked one step at a time in both directions — no
level skipping — so the WL trace under a load profile is deterministic
and testable.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass
class PrecisionPolicy:
    """Hysteresis map (queue depth, p95 queue wait) → serving word length.

    ``levels`` is the WL ladder, strictly descending, ``levels[0]`` = full
    precision. Pressure = depth ≥ ``high_watermark`` OR (when
    ``p95_high_ms`` > 0) p95 queue wait ≥ ``p95_high_ms``; drain = depth ≤
    ``low_watermark`` and no latency pressure. ``patience`` consecutive
    pressure observations step one level DOWN; ``patience`` consecutive
    drain observations step one level UP."""

    levels: Tuple[int, ...] = (8, 6, 4)
    high_watermark: int = 8
    low_watermark: int = 1
    p95_high_ms: float = 0.0
    patience: int = 2

    def __post_init__(self):
        if not self.levels:
            raise ValueError("PrecisionPolicy: empty level ladder")
        if list(self.levels) != sorted(set(self.levels), reverse=True):
            raise ValueError(
                f"PrecisionPolicy: levels must be strictly descending, got "
                f"{self.levels}")
        if self.low_watermark >= self.high_watermark:
            raise ValueError(
                "PrecisionPolicy: low_watermark must be < high_watermark "
                f"({self.low_watermark} >= {self.high_watermark})")
        if self.patience < 1:
            raise ValueError("PrecisionPolicy: patience must be >= 1")
        self._idx = 0
        self._down = 0
        self._up = 0

    @classmethod
    def from_config(cls, scfg) -> "PrecisionPolicy":
        """Build from a ``config.ServeConfig``."""
        return cls(levels=tuple(scfg.degrade_levels),
                   high_watermark=scfg.degrade_high_watermark,
                   low_watermark=scfg.degrade_low_watermark,
                   p95_high_ms=scfg.degrade_p95_ms,
                   patience=scfg.degrade_patience)

    @property
    def wl(self) -> int:
        return self.levels[self._idx]

    def observe(self, queue_depth: int, p95_wait_ms: float = 0.0) -> int:
        """Feed one per-step observation; returns the active WL after it."""
        latency_pressure = (self.p95_high_ms > 0.0
                            and p95_wait_ms >= self.p95_high_ms)
        pressure = queue_depth >= self.high_watermark or latency_pressure
        drained = queue_depth <= self.low_watermark and not latency_pressure
        if pressure:
            self._up = 0
            self._down += 1
            if self._down >= self.patience and \
                    self._idx < len(self.levels) - 1:
                self._idx += 1
                self._down = 0
        elif drained:
            self._down = 0
            self._up += 1
            if self._up >= self.patience and self._idx > 0:
                self._idx -= 1
                self._up = 0
        else:                       # between watermarks: hold, reset both
            self._down = 0
            self._up = 0
        return self.levels[self._idx]
