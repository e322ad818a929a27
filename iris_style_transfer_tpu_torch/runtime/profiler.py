"""Profiler traces, the program's spans, and wall-clock step counters.

Counterpart of ``iris_style_transfer_tpu/runtime/profiler.py``: ``trace``
records a torch.profiler trace where the JAX package takes a
``jax.profiler`` one.  For :class:`StepTimer` the caller synchronizes the
device inside the timed block, so a step's time is the device's time and
not the enqueue's.

**Spans.** ``with span("ist.nst"):`` names a phase of the program.  Off is
the normal state: while no torch.profiler records on the calling thread,
``span`` returns one shared no-op context manager, and that check is its
whole cost.  While a profiler records, a span is a host range in the
trace, beside the kernels on the profiler's clock, and it appends a
record: its name, the span that encloses it on its thread, the run and
batch it belongs to, its thread, its host start and end
(``perf_counter_ns``) and, on the main thread once CUDA is initialised,
two timing ``torch.cuda.Event`` s recorded on the current stream at its
start and end.  :func:`spans` reads
a run's records, device milliseconds included, after one synchronize;
nothing is read back while the spans run.

The range is a RecordFunction at function scope
(``torch._C._profiler._RecordFunctionFast``: an op in the trace, the ops
under it its children), not ``torch.profiler.record_function``'s user
scope, which Kineto also projects onto the card's timeline as a
``gpu_user_annotation`` from the span's first kernel to its last: a
reading of the card's busy time from the trace would count the idle time
inside every span as busy.

A run is one sweep of an IST main or one epoch of the gaze main
(:func:`new_run`), and its batch index is set as the loop goes
(:func:`at_batch`); both are attributes of the
records, never profiler ranges, so the outermost ranges of a trace are the
program's phases.  The last :data:`KEEP_RUNS` runs are kept.

The spans, by name: ``ist.load`` (the fetch of a batch and its shard),
``ist.stage`` (the 2020 pre program's quantize and host-to-card copy),
``ist.pre``, ``ist.post``, ``ist.seg`` (2019; each per-batch program with
the hand-off of its metrics to the worker thread), ``ist.nst``,
``ist.nst_sync`` (the NST timer's synchronize), ``ist.save`` (the PNGs),
``ist.metric_job`` (each job of the metric worker thread, host time
only), ``ist.drain``, ``ist.aggregate`` (the epoch-end metrics and
arrays); ``nst.grad`` (each closure's loss and gradient), ``lbfgs.step``;
``b7.apply``, ``resnet50.apply``, ``ritnet.apply``; ``halo_rows`` and
``halo_rows_backward`` (spatial sharding's row exchange); in the gaze
main ``gaze.load`` (the wait for the next staged batch), ``gaze.grad``
(a step's forward, loss and backward), ``gaze.adam`` (its Adam step),
``gaze.eval`` (a validation batch), ``gaze.metrics`` (the epoch-end
metrics).
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import threading
import time
from typing import NamedTuple

import torch

KEEP_RUNS = 8  # the benchmark retries a dropped trace up to 4 times, each retry a run
PROFILER_TRIES = 4

_OFF = contextlib.nullcontext()
_ids = itertools.count()
_open = threading.local()  # each thread's stack of open records
_lock = threading.Lock()  # the metric worker's spans append beside the main thread's
_runs: collections.OrderedDict[int, list] = collections.OrderedDict()
_run = 0
_batch: int | None = None


class Span(NamedTuple):
    """One span as :func:`spans` reads it.  ``device_ms`` is the time
    between its two CUDA events (idle time inside the span included), None
    without them; ``self_ms`` is its time (device where it has it, else
    host) less that of the spans it encloses."""

    id: int
    name: str
    parent: int | None
    run: int
    batch: int | None
    thread: str
    start_ns: int
    end_ns: int
    host_ms: float
    device_ms: float | None
    self_ms: float


class _Record:
    __slots__ = ("id", "name", "parent", "run", "batch", "thread", "start_ns", "end_ns", "events", "rf")

    def __init__(self, name: str, run: int, batch: int | None):
        self.id, self.name, self.run, self.batch = next(_ids), name, run, batch
        self.parent, self.end_ns, self.events, self.rf = None, None, None, None
        self.thread = threading.current_thread().name

    def __enter__(self):
        stack = _stack()
        self.parent = stack[-1].id if stack else None
        with _lock:
            held = _runs.get(self.run)
            if held is None and self.run == _run:
                held = _runs[self.run] = []
                while len(_runs) > KEEP_RUNS:
                    _runs.popitem(last=False)
            if held is not None:  # else a job of a run no longer kept
                held.append(self)
        stack.append(self)
        self.start_ns = time.perf_counter_ns()
        self.rf = torch._C._profiler._RecordFunctionFast(self.name)
        self.rf.__enter__()
        if torch.cuda.is_initialized() and threading.current_thread() is threading.main_thread():
            self.events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            self.events[0].record()
        return self

    def __exit__(self, *exc):
        if self.events is not None:
            self.events[1].record()
        self.rf.__exit__(*exc)
        self.rf = None
        self.end_ns = time.perf_counter_ns()
        _stack().pop()
        return False


def _stack() -> list:
    stack = getattr(_open, "stack", None)
    if stack is None:
        stack = _open.stack = []
    return stack


def span(name: str):
    """A span named ``name`` while torch.profiler records on this thread,
    else the shared no-op."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return _Record(name, _run, _batch)


def job(name: str, fn):
    """``fn`` as it is while no profiler records on the calling thread;
    else ``fn`` wrapped to run inside a span named ``name`` on whatever
    thread calls it, in the caller's run and batch.  For work handed to
    another thread, which the profiler does not see: the span is a host
    record there, and a range only where the profiler records that thread
    too."""
    if not torch.autograd._profiler_enabled():
        return fn
    run, batch = _run, _batch

    def spanned(*args, **kw):
        with _Record(name, run, batch):
            return fn(*args, **kw)

    return spanned


def new_run() -> int:
    """Start a run (one sweep): the spans from here on belong to it, with
    no batch index until :func:`at_batch`.  Returns its id."""
    global _run, _batch
    _run, _batch = _run + 1, None
    return _run


def at_batch(index: int | None) -> None:
    """The batch index of the spans from here on."""
    global _batch
    _batch = index


def spans(run: int | None = None) -> list[Span]:
    """The closed spans of ``run`` (None: the last run begun), in the order
    they were entered, after one device synchronize where any has events."""
    with _lock:
        recs = [r for r in _runs.get(_run if run is None else run, ()) if r.end_ns is not None]
    if any(r.events is not None for r in recs):
        torch.cuda.synchronize()
    own = {}
    for r in recs:
        host = (r.end_ns - r.start_ns) / 1e6
        dev = r.events[0].elapsed_time(r.events[1]) if r.events is not None else None
        own[r.id] = (host, dev)
    inner = collections.defaultdict(float)
    for r in recs:
        if r.parent in own:
            host, dev = own[r.id]
            inner[r.parent] += host if dev is None else dev
    out = []
    for r in recs:
        host, dev = own[r.id]
        out.append(Span(r.id, r.name, r.parent, r.run, r.batch, r.thread, r.start_ns, r.end_ns, host, dev,
                        (host if dev is None else dev) - inner[r.id]))
    return out


@contextlib.contextmanager
def trace(log_dir: str | None):
    """``with trace("/tmp/trace"):`` records the host's and, where CUDA is
    available, the card's activity under torch.profiler and writes a Chrome
    trace (``<pid>.<ns>.pt.trace.json``, for chrome://tracing or Perfetto)
    into ``log_dir``, the program's spans in it as host ranges; does
    nothing when ``log_dir`` is None.  :func:`spans` reads the spans'
    records after it."""
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, f"{os.getpid()}.{time.time_ns()}.pt.trace.json"))


def traced(fn, ok, what: str, cpu: bool = True):
    """Key averages of ``fn`` (then a device sync) under torch.profiler,
    and the number of traces that took.  On the H100 the profiler drops
    kernel events: after a process's first few traces, the first kernel
    of each trace, and now and then every event of several short traces
    in a row.  So a trace whose key averages ``ok`` rejects is taken again
    after a pause, up to PROFILER_TRIES times in all; raises
    AssertionError naming ``what`` if none passes.  ``cpu=False`` traces
    the card alone.  A caller that counts launches around this call
    counts those of every try."""
    from torch.profiler import ProfilerActivity, profile

    acts = ([ProfilerActivity.CPU] if cpu else []) + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    for tries in range(1, PROFILER_TRIES + 1):
        if tries > 1:
            time.sleep(1.0)
        with profile(activities=acts) as prof:
            fn()
            if torch.cuda.is_available():
                torch.cuda.synchronize()
        ev = prof.key_averages()
        if ok(ev):
            if tries > 1:
                print(f"[profiler] {what}: traced on try {tries}", flush=True)
            return ev, tries
    raise AssertionError(f"torch.profiler did not trace {what} in {PROFILER_TRIES} tries")


def sync(device: torch.device) -> None:
    """Wait for the work queued on ``device`` when it is a CUDA device: the
    synchronize that ends a :class:`StepTimer` block."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


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
