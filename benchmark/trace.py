"""Reading the card's work from torch.profiler.

``traced`` is a copy of ``chip_smoke.py``'s ``_trace``, retries included:
on the H100 the profiler drops kernel events (after a process's first few
traces, the first kernel of each trace, and now and then every event of
several short traces in a row), so a trace that lacks what it is asked
for is taken again.  A reader that wants a kernel's device time takes, as
``_device_ms`` does, its mean time a launch times the launches the work
makes, so that a dropped event does not shrink the sum.  ``Summary``
reduces one trace to what the per-layer readers take: each
kernel's launches and device time, the union of the device's busy
intervals against the traced window's wall time, and the ``breakdown``
(the device operations that took most time, the longest idle gaps named
by what the host was doing meanwhile).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import torch

PROFILER_TRIES = 4


def traced(fn, ok, what: str):
    """``fn`` (then a device sync) under torch.profiler: (profile, wall
    seconds of the traced window, tries).  A trace that ``ok(profile)``
    rejects is taken again after a pause, up to PROFILER_TRIES times in
    all; raises naming ``what`` if none passes."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    for tries in range(1, PROFILER_TRIES + 1):
        if tries > 1:
            time.sleep(1.0)
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        if ok(prof):
            return prof, wall, tries
    raise AssertionError(f"torch.profiler did not trace {what} in {PROFILER_TRIES} tries")


def _is_device(e) -> bool:
    return "cuda" in str(getattr(e, "device_type", "")).lower()


def union_s(intervals: list[tuple[float, float]]) -> tuple[float, list[tuple[float, float]]]:
    """Seconds covered by (start_us, end_us) intervals, and the gaps
    between them as (start_us, end_us)."""
    busy, gaps, end = 0.0, [], None
    for a, b in sorted(intervals):
        if end is None or a > end:
            if end is not None:
                gaps.append((end, a))
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy / 1e6, gaps


@dataclass
class Summary:
    """One trace, reduced: per kernel (launches, device seconds); busy and
    window seconds; the breakdown."""

    kernels: dict[str, tuple[int, float]] = field(default_factory=dict)
    busy_s: float = 0.0
    window_s: float = 0.0
    breakdown: dict = field(default_factory=dict)

    def kernel_time(self, part: str) -> tuple[int, float]:
        """Launches and device seconds of every kernel whose name holds ``part``."""
        n, s = 0, 0.0
        for name, (k, t) in self.kernels.items():
            if part in name:
                n, s = n + k, s + t
        return n, s


def _short(name: str, n: int = 96) -> str:
    return name if len(name) <= n else name[: n - 3] + "..."


def summarize(prof, wall_s: float) -> Summary:
    kernels: dict[str, tuple[int, float]] = {}
    dev, host = [], []
    for e in prof.events():
        tr = e.time_range
        if _is_device(e):
            dev.append((tr.start, tr.end))
            k, t = kernels.get(e.name, (0, 0.0))
            kernels[e.name] = (k + 1, t + (tr.end - tr.start) / 1e6)
        elif getattr(e, "cpu_parent", None) is None:
            host.append((tr.start, tr.end, e.name))
    busy, gaps = union_s(dev)
    host.sort()
    named: list[list] = []
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:10]:
        mid = (a + b) / 2
        what = next((nm for s, t, nm in host if s <= mid <= t), "host idle")
        named.append([_short(what), (b - a) / 1e6])
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:10]
    return Summary(
        kernels=kernels,
        busy_s=busy,
        window_s=wall_s,
        breakdown={"device_ops": [[_short(n), t] for n, (_, t) in top], "idle_gaps": named},
    )


def has_kernels(parts) -> callable:
    """An ``ok`` for :func:`traced`: every name part has a device event."""
    def ok(prof) -> bool:
        names = {e.name for e in prof.events() if _is_device(e)}
        return all(any(p in n for n in names) for p in parts)
    return ok
