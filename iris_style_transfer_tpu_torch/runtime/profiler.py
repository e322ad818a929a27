"""Profiler traces and wall-clock step counters.

Counterpart of ``iris_style_transfer_tpu/runtime/profiler.py``: ``trace``
records a torch.profiler trace where the JAX package takes a
``jax.profiler`` one.  For :class:`StepTimer` the caller synchronizes the
device inside the timed block, so a step's time is the device's time and
not the enqueue's.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def trace(log_dir: str | None):
    """``with trace("/tmp/trace"):`` records the host's and, where CUDA is
    available, the card's activity under torch.profiler and writes a Chrome
    trace (``<pid>.<ns>.pt.trace.json``, for chrome://tracing or Perfetto)
    into ``log_dir``; does nothing when ``log_dir`` is None."""
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, f"{os.getpid()}.{time.time_ns()}.pt.trace.json"))


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
