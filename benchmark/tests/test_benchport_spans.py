"""The readers of the program's spans (``metrics/_spans.py`` and the seven
metrics on it) on synthetic span lists: the per-batch and per-sweep sums,
and None where the run was not traced, the program has no spans, or a
span's count differs from the cell's work."""

import os
from types import SimpleNamespace

import pytest

from benchmark import harness

READERS = ("transfer.closure_grad_ms", "transfer.lbfgs_step_ms", "models.b7_ms", "models.resnet50_ms",
           "models.ritnet_ms", "workloads.load_ms", "workloads.drain_ms")


def _reader(name):
    return harness.load_module(os.path.join(harness.BENCH_DIR, "metrics", f"{name}.py"), f"benchmark.metrics.{name}")


def _span(name, device_ms=None, host_ms=0.0):
    return SimpleNamespace(name=name, device_ms=device_ms, host_ms=host_ms)


def _run(cell: str, trace=True):
    return SimpleNamespace(cell=harness.Cell.load(cell), trace=object() if trace else None)


def _spans_2020(batches=2, closures=20, drop=None):
    """A 2020 sweep at bs 128 in chunks of 32: per batch 8 B7 and 8
    ResNet50 applies, ``closures`` gradients and steps, one stage."""
    out = [_span("ist.load", host_ms=1.0)]  # the fetch that ends the loop
    for _ in range(batches):
        out += [_span("ist.load", host_ms=2.0), _span("ist.pre", 100.0), _span("ist.stage", 5.0, 7.0)]
        out += [_span("b7.apply", 30.0) for _ in range(8)] + [_span("resnet50.apply", 4.0) for _ in range(8)]
        out += [_span("ist.nst", 60.0)]
        out += [_span("nst.grad", 2.5) for _ in range(closures)] + [_span("lbfgs.step", 0.5) for _ in range(closures)]
    out += [_span("ist.drain", 3.0, 11.0), _span("ist.aggregate", None, 4.0)]
    if drop is not None:
        out.remove(next(s for s in out if s.name == drop))
    return out


@pytest.fixture
def spans_are(monkeypatch):
    from iris_style_transfer_tpu_torch.runtime import profiler

    def set_to(spans):
        monkeypatch.setattr(profiler, "spans", lambda run=None: spans)

    return set_to


def test_per_batch_sums_2020(spans_are):
    spans_are(_spans_2020())
    run = _run("ist2020-bs128-nst20")
    got = {name: _reader(name).read(run) for name in READERS}
    assert got == {
        "transfer.closure_grad_ms": pytest.approx(20 * 2.5),
        "transfer.lbfgs_step_ms": pytest.approx(20 * 0.5),
        "models.b7_ms": pytest.approx(8 * 30.0),
        "models.resnet50_ms": pytest.approx(8 * 4.0),
        "models.ritnet_ms": None,  # no RITnet in the 2020 cell
        "workloads.load_ms": pytest.approx((1.0 + 2 * 2.0 + 2 * 7.0) / 2),
        "workloads.drain_ms": pytest.approx(15.0),  # a sweep's, host clock
    }


def test_per_batch_sums_2019(spans_are):
    spans = [_span("ist.load", host_ms=0.5)]
    for _ in range(3):
        spans += [_span("ist.load", host_ms=0.25), _span("ist.pre", 10.0)]
        spans += [_span("ritnet.apply", 20.0), _span("ritnet.apply", 22.0)]  # bs 64 in chunks of 32
        spans += [_span("nst.grad", 27.0) for _ in range(200)] + [_span("lbfgs.step", 3.0) for _ in range(200)]
    spans += [_span("ist.drain", host_ms=50.0), _span("ist.aggregate", host_ms=25.0)]
    spans_are(spans)
    run = _run("ist2019-bs64")
    assert _reader("models.ritnet_ms").read(run) == pytest.approx(42.0)
    assert _reader("transfer.closure_grad_ms").read(run) == pytest.approx(5400.0)
    assert _reader("transfer.lbfgs_step_ms").read(run) == pytest.approx(600.0)
    assert _reader("workloads.load_ms").read(run) == pytest.approx((0.5 + 3 * 0.25) / 3)
    assert _reader("workloads.drain_ms").read(run) == pytest.approx(75.0)
    assert _reader("models.b7_ms").read(run) is None


@pytest.mark.parametrize("drop,reader", [
    ("nst.grad", "transfer.closure_grad_ms"), ("lbfgs.step", "transfer.lbfgs_step_ms"),
    ("b7.apply", "models.b7_ms"), ("resnet50.apply", "models.resnet50_ms"), ("ist.load", "workloads.load_ms"),
    ("ist.stage", "workloads.load_ms"), ("ist.drain", "workloads.drain_ms"), ("ist.aggregate", "workloads.drain_ms"),
])
def test_a_lost_span_gives_none(spans_are, drop, reader):
    spans_are(_spans_2020(drop=drop))
    assert _reader(reader).read(_run("ist2020-bs128-nst20")) is None


def test_other_closures_than_the_cells_give_none(spans_are):
    spans_are(_spans_2020(closures=19))
    run = _run("ist2020-bs128-nst20")
    assert _reader("transfer.closure_grad_ms").read(run) is None
    assert _reader("transfer.lbfgs_step_ms").read(run) is None


def test_no_trace_no_spans_no_device_clock(spans_are, monkeypatch):
    spans_are(_spans_2020())
    for name in READERS:
        assert _reader(name).read(_run("ist2020-bs128-nst20", trace=False)) is None
    spans_are([])
    for name in READERS:
        assert _reader(name).read(_run("ist2020-bs128-nst20")) is None
    spans_are([SimpleNamespace(**{**vars(s), "device_ms": None}) for s in _spans_2020()])  # a CPU run
    assert _reader("models.b7_ms").read(_run("ist2020-bs128-nst20")) is None
    assert _reader("workloads.load_ms").read(_run("ist2020-bs128-nst20")) is not None
    from iris_style_transfer_tpu_torch.runtime import profiler

    monkeypatch.delattr(profiler, "spans")  # a program from before the spans
    for name in READERS:
        assert _reader(name).read(_run("ist2020-bs128-nst20")) is None
