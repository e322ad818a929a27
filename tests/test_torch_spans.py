"""The port's spans (``runtime/profiler.py``) on the CPU: off, a span is the
shared no-op and records nothing; under torch.profiler it is a range in
the trace and a record with its parent, run and batch; each IST main's
sweep emits the spans a batch that the benchmark's readers count, and
gives bit for bit the outputs it gives unprofiled.  Also the retrying
``traced``."""

import json
import random
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from iris_style_transfer_tpu_torch.data import build_ist_dataset
from iris_style_transfer_tpu_torch.data import synthetic as tsyn
from iris_style_transfer_tpu_torch.models import EfficientNet, GazeEstimator1, GazeEstimator2, RITnet, VGG19
from iris_style_transfer_tpu_torch.parallel import mesh as mesh_mod
from iris_style_transfer_tpu_torch.runtime import MetricLogger, profiler
from iris_style_transfer_tpu_torch.runtime.config import WorkloadConfig
from iris_style_transfer_tpu_torch.workloads import ist_openeds2019 as wl2019
from iris_style_transfer_tpu_torch.workloads import ist_openeds2020 as wl2020

H, W = 48, 64
CLOSURES = 2
TIMING = ("nst_batches_per_sec", "stylized_images_per_min", "pipeline_images_per_min")


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


@pytest.fixture
def one_thread():
    """One intra-op thread: B7's plain depthwise is thousands of small ops,
    each a parallel region that waits on every thread, which beside the
    other test workers' threads multiplied this file's time fifty-fold."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_span_off_is_the_shared_noop(monkeypatch):
    def fail(*a, **k):
        raise AssertionError("record_function called with no profiler on")

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", fail)
    monkeypatch.setattr(torch.profiler, "record_function", fail)
    assert not torch.autograd._profiler_enabled()
    run = profiler.new_run()
    assert profiler.span("a") is profiler.span("b") is profiler._OFF
    with profiler.span("a"), profiler.span("b"):
        torch.ones(3).add_(1)
    fn = len
    assert profiler.job("ist.metric_job", fn) is fn
    assert profiler.spans() == [] and profiler.spans(run) == []
    assert not hasattr(mesh_mod, "_span")  # one span facility in the port


def test_span_on_records_its_parent_run_and_batch(tmp_path):
    with _cpu_profile() as prof:
        run = profiler.new_run()
        profiler.at_batch(3)
        with profiler.span("outer"):
            with profiler.span("inner"):
                torch.ones(64).mul(2.0)
            job = profiler.job("job", lambda v: v + 1)
        profiler.at_batch(4)
        with profiler.span("later"):
            pass
        with ThreadPoolExecutor(1) as pool:
            assert pool.submit(job, 1).result() == 2
    recs = {s.name: s for s in profiler.spans()}
    assert set(recs) == {"outer", "inner", "job", "later"}
    outer, inner, later, worker = recs["outer"], recs["inner"], recs["later"], recs["job"]
    assert outer.parent is None and inner.parent == outer.id and later.parent is None
    assert worker.parent is None and worker.thread != outer.thread  # its own thread's stack
    assert {s.run for s in recs.values()} == {run}
    assert (outer.batch, inner.batch, worker.batch, later.batch) == (3, 3, 3, 4)
    assert all(s.device_ms is None and s.host_ms >= 0 for s in recs.values())  # no CUDA here
    assert outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns
    assert outer.self_ms == pytest.approx(outer.host_ms - inner.host_ms)
    assert [s.name for s in profiler.spans()] == ["outer", "inner", "later", "job"]  # entry order
    events = prof.events()
    assert {"outer", "inner", "later"} <= {e.name for e in events}
    # host ops, not user annotations (which Kineto mirrors onto the card's timeline)
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    cats = {e.get("cat") for e in json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
            if e.get("name") in recs}
    assert cats == {"cpu_op"}
    mul = next(e for e in events if e.name == "aten::mul")
    chain, e = [], mul.cpu_parent
    while e is not None:
        chain.append(e.name)
        e = e.cpu_parent
    assert chain[-2:] == ["inner", "outer"]


def test_runs_are_bounded():
    first = None
    with _cpu_profile():
        for _ in range(profiler.KEEP_RUNS + 2):
            run = profiler.new_run()
            first = first or run
            with profiler.span("s"):
                pass
    kept = [r for r in range(first, run + 1) if profiler.spans(r)]
    assert kept == list(range(run - profiler.KEEP_RUNS + 1, run + 1))


def test_concurrent_spans_lose_no_record():
    """Many threads open spans of one new run at once (its record list made
    by whichever comes first): every record is kept."""
    threads, each = 16, 100
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with _cpu_profile():
            run = profiler.new_run()
            k = profiler.job("k", lambda: None)
            fn = profiler.job("j", lambda: [k() for _ in range(2)])
            with ThreadPoolExecutor(threads) as pool:
                futs = [pool.submit(lambda: [fn() for _ in range(each)]) for _ in range(threads)]
                for f in futs:
                    f.result(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    spans = profiler.spans(run)
    names = [s.name for s in spans]
    assert names.count("j") == threads * each and names.count("k") == 2 * threads * each
    byid = {s.id: s for s in spans}
    assert all(byid[s.parent].name == "j" and byid[s.parent].thread == s.thread for s in spans if s.name == "k")


@pytest.mark.parametrize("fails", [0, 2])
def test_traced_retries_a_rejected_trace(monkeypatch, fails):
    monkeypatch.setattr(profiler.time, "sleep", lambda s: None)
    seen = []

    def ok(ev):
        seen.append(any(e.key == "aten::add" for e in ev))
        return len(seen) > fails

    ev, tries = profiler.traced(lambda: torch.ones(4).add(1), ok, "an add")
    assert tries == fails + 1 and all(seen)
    assert any(e.key == "aten::add" for e in ev)


def test_traced_raises_naming_what_it_missed(monkeypatch):
    monkeypatch.setattr(profiler.time, "sleep", lambda s: None)
    calls = []
    with pytest.raises(AssertionError, match="a kernel that never runs"):
        profiler.traced(lambda: calls.append(1), lambda ev: False, "a kernel that never runs")
    assert len(calls) == profiler.PROFILER_TRIES


def _counts(spans, batch):
    out = {}
    for s in spans:
        if s.batch == batch:
            out[s.name] = out.get(s.name, 0) + 1
    return out


def _capture(programs, outs):
    """The programs, each keeping a copy of what it returns."""

    def keep(fn):
        def run(*a, **k):
            out = fn(*a, **k)
            outs.append([t.clone() if torch.is_tensor(t) else [p.clone() for p in t] for t in out])
            return out

        return run

    return tuple(keep(f) for f in programs)


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, list):
            _same(x, y)
        else:
            assert torch.equal(x, y)


def _sweep_twice(sweep, make_programs, tmp_path):
    """The sweep unprofiled, then under the CPU profiler: the logs (less
    the timings), the arrays and every program output agree bit for bit;
    returns the profiled run's spans."""
    results = []
    for name in ("plain", "profiled"):
        outs = []
        out_dir = tmp_path / name
        out_dir.mkdir()
        logger = MetricLogger("t", name, out_dir=str(out_dir / "logs"))
        if name == "plain":
            log = sweep(_capture(make_programs(), outs), f"{out_dir}/", logger)
        else:
            with _cpu_profile():
                log = sweep(_capture(make_programs(), outs), f"{out_dir}/", logger)
        logger.finish()
        results.append(({k: v for k, v in log.items() if not k.endswith(TIMING)}, outs, out_dir))
    (log0, outs0, dir0), (log1, outs1, dir1) = results
    assert log0 == log1
    _same(outs0, outs1)
    arrays = sorted(p.name for p in dir0.glob("*.npy"))
    assert arrays
    for a in arrays:
        np.testing.assert_array_equal(np.load(dir0 / a), np.load(dir1 / a))
    return profiler.spans()  # (the trace's events are not read: 160,000 of them take seconds to parse)


def _check_sweep(spans, batches):
    """What a sweep of ``batches`` emits outside its batches: the fetch
    that ends the loop, the drain and the aggregation; every phase at the
    top of its thread, and one run."""
    assert _counts(spans, batches) == {"ist.load": 1}
    assert _counts(spans, None) == {"ist.drain": 1, "ist.aggregate": 1}
    assert all(s.parent is None for s in spans if s.name.startswith("ist.") and s.name != "ist.stage")
    assert len({s.run for s in spans}) == 1


def test_ist2019_sweep_spans_and_outputs(tmp_path, one_thread):
    gen = torch.Generator().manual_seed(0)
    _, _, _, xs, ys, ms, num_class = tsyn.synthetic_openeds2019(3, 2, seed=1, height=H, width=W)
    xs, ys, ms = xs[:2], ys[:2], ms[:2]
    assert len(set(ys)) == 2  # each frame's donor is the other user's
    random.seed(0)
    ritnet = RITnet.pretrained()
    ds = build_ist_dataset(xs, ys, ms, ritnet)

    def mlp(din):
        return {f"fc{i}": {"w": torch.randn(e, d, generator=gen) / d ** 0.5, "b": torch.zeros(e)}
                for i, (d, e) in enumerate(((din, 16), (16, 16), (16, num_class)))}

    vgg, c1, c2 = VGG19.init(gen), mlp(512 * 49), mlp(1920)
    cfg = WorkloadConfig(bs=1, compute_dtype="float32")

    def sweep(programs, out, logger):
        return wl2019.iris_style_transfer_openeds2019(
            cfg, ds, vgg, ritnet, c1, c2, 1.0, 1.0, CLOSURES, "test/", out, logger, torch.device("cpu"),
            num_class=num_class, programs=programs)

    spans = _sweep_twice(sweep, lambda: wl2019.make_programs(torch.float32), tmp_path)
    per_batch = {"ist.load": 1, "ist.pre": 1, "ist.nst": 1, "ist.nst_sync": 1, "ist.post": 1, "ist.seg": 1,
                 "ritnet.apply": 1, "ist.metric_job": 4, "nst.grad": CLOSURES, "lbfgs.step": CLOSURES}
    first = dict(per_batch, **{"ist.save": 2})  # batch 0 writes its PNGs
    for b, want in enumerate((first, per_batch)):
        assert _counts(spans, b) == want, b
    _check_sweep(spans, 2)
    byid = {s.id: s for s in spans}
    for s in spans:
        if s.name in ("nst.grad", "lbfgs.step"):
            assert byid[s.parent].name == "ist.nst"
        if s.name == "ritnet.apply":
            assert byid[s.parent].name == "ist.seg"


def test_ist2020_sweep_spans_and_outputs(tmp_path, one_thread):
    gen = torch.Generator().manual_seed(0)
    imgs, _, _, labels = tsyn.synthetic_eye_batch(3, H, W, seed=5, gaze=True)
    eff = EfficientNet.init(gen)
    g1 = GazeEstimator1.init(gen)
    g2 = GazeEstimator2.init(gen, extract_feature=True)
    vgg = VGG19.init(gen)
    s_iris = torch.rand(224, 224, 1, generator=gen)
    cfg = WorkloadConfig(bs=2, compute_dtype="float32")
    cpu = torch.device("cpu")

    def sweep(programs, out, logger):
        return wl2020.iris_style_transfer_openeds2020(
            cfg, imgs, labels, eff, g1, g2, vgg, s_iris, 1.0, 1.0, CLOSURES, "validation/", out, logger, cpu,
            programs=programs)

    spans = _sweep_twice(sweep, lambda: wl2020.make_programs(cfg.glint_threshold, torch.float32, cpu), tmp_path)
    per_batch = {"ist.load": 1, "ist.stage": 1, "ist.pre": 1, "ist.nst": 1, "ist.nst_sync": 1, "ist.post": 1,
                 "b7.apply": 2, "resnet50.apply": 2, "ist.metric_job": 3, "nst.grad": CLOSURES,
                 "lbfgs.step": CLOSURES}
    first = dict(per_batch, **{"ist.save": 2})
    for b, want in enumerate((first, per_batch)):
        assert _counts(spans, b) == want, b
    _check_sweep(spans, 2)
    byid = {s.id: s for s in spans}
    assert {byid[s.parent].name for s in spans if s.name in ("b7.apply", "resnet50.apply", "ist.stage")} == {
        "ist.pre", "ist.post"}
