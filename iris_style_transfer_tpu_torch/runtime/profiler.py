"""Wall-clock step counters.

Counterpart of ``iris_style_transfer_tpu/runtime/profiler.py:StepTimer``.
The caller synchronizes the device inside the timed block, so a step's
time is the device's time and not the enqueue's.
"""

from __future__ import annotations

import time


class StepTimer:
    """Steps/sec and items/sec, excluding the first (warm-up) measurement
    by default."""

    def __init__(self, skip_first: bool = True):
        self.skip_first = skip_first
        self.times: list[float] = []
        self._t0 = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.times.append(time.perf_counter() - self._t0)

    @property
    def measured(self) -> list[float]:
        return self.times[1:] if (self.skip_first and len(self.times) > 1) else self.times

    def per_sec(self, units_per_step: float = 1.0) -> float:
        m = self.measured
        if not m:
            return 0.0
        return units_per_step * len(m) / sum(m)
