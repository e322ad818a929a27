"""Readings of the program's own spans (``runtime/profiler.py`` in the
port) over the traced slice's run: a sum of the spans of some names, each
a count the cell's work fixes, per batch or per sweep.  None where the run
was not traced, the program has no spans, or a count differs from the
work, so that a lost span cannot shrink a sum."""

from __future__ import annotations

import math

RITNET_CHUNK = 32  # frames per RITnet apply in the 2019 main's re-segmentation (make_programs' seg_chunk)


def program_spans(run):
    """The spans of the last run the program began (the traced slice's),
    or None."""
    if run.trace is None:
        return None
    try:
        from iris_style_transfer_tpu_torch.runtime import profiler
    except ImportError:
        return None
    read = getattr(profiler, "spans", None)
    return read() if read is not None else None


def count(spans, name: str) -> int:
    return sum(s.name == name for s in spans)


def batches(spans) -> int:
    """The run's batches: one ``ist.pre`` span each."""
    return count(spans, "ist.pre")


def total_ms(spans, name: str, want: int, clock: str) -> float | None:
    """The ``clock`` ("device" or "host") milliseconds of the spans named
    ``name``; None unless there are ``want`` of them, each with that clock."""
    picked = [s for s in spans if s.name == name]
    if len(picked) != want:
        return None
    ms = [s.device_ms if clock == "device" else s.host_ms for s in picked]
    return None if any(m is None for m in ms) else sum(ms)


def per_batch(run, name: str, per: int, clock: str = "device") -> float | None:
    """Milliseconds a batch of the spans named ``name``, ``per`` of them a
    batch."""
    spans = program_spans(run)
    if not spans:
        return None
    b = batches(spans)
    if b == 0:
        return None
    ms = total_ms(spans, name, per * b, clock)
    return None if ms is None else ms / b


def chunks_a_batch(run, chunk: int) -> int:
    """Calls a batch of a model applied in chunks of ``chunk`` frames."""
    return math.ceil(run.cell.traffic["batch_size"] / chunk)
