"""The IST sweep's metric worker (``workloads/sweep.py``) on the CPU, for
both mains at the slice tests' size: a metric job that raises makes the
sweep call raise that error once the drain reads it, and the worker
thread is shut down, not left running."""

import random
import threading

import pytest
import torch

from iris_style_transfer_tpu_torch.data import build_ist_dataset
from iris_style_transfer_tpu_torch.data import synthetic as tsyn
from iris_style_transfer_tpu_torch.models import EfficientNet, GazeEstimator1, GazeEstimator2, RITnet, VGG19
from iris_style_transfer_tpu_torch.runtime import MetricLogger
from iris_style_transfer_tpu_torch.runtime.config import WorkloadConfig
from iris_style_transfer_tpu_torch.workloads import ist_openeds2019 as wl2019
from iris_style_transfer_tpu_torch.workloads import ist_openeds2020 as wl2020

H, W = 48, 64
CPU = torch.device("cpu")


@pytest.fixture
def one_thread():
    """One intra-op thread, as in ``tests/test_torch_spans.py``: B7's plain
    depthwise is thousands of small parallel regions."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _sweep2019(out: str, logger):
    gen = torch.Generator().manual_seed(0)
    _, _, _, xs, ys, ms, num_class = tsyn.synthetic_openeds2019(3, 2, seed=1, height=H, width=W)
    random.seed(0)
    ritnet = RITnet.pretrained()
    ds = build_ist_dataset(xs[:2], ys[:2], ms[:2], ritnet)

    def mlp(din):
        return {f"fc{i}": {"w": torch.randn(e, d, generator=gen) / d ** 0.5, "b": torch.zeros(e)}
                for i, (d, e) in enumerate(((din, 16), (16, 16), (16, num_class)))}

    cfg = WorkloadConfig(bs=1, compute_dtype="float32")
    return wl2019.iris_style_transfer_openeds2019(
        cfg, ds, VGG19.init(gen), ritnet, mlp(512 * 49), mlp(1920), 1.0, 1.0, 1, "test/", out, logger, CPU,
        num_class=num_class)


def _sweep2020(out: str, logger):
    gen = torch.Generator().manual_seed(0)
    imgs, _, _, labels = tsyn.synthetic_eye_batch(3, H, W, seed=5, gaze=True)
    eff, g1 = EfficientNet.init(gen), GazeEstimator1.init(gen)
    g2 = GazeEstimator2.init(gen, extract_feature=True)
    cfg = WorkloadConfig(bs=2, compute_dtype="float32")
    return wl2020.iris_style_transfer_openeds2020(
        cfg, imgs, labels, eff, g1, g2, VGG19.init(gen), torch.rand(224, 224, 1, generator=gen), 1.0, 1.0, 1,
        "validation/", out, logger, CPU)


@pytest.mark.parametrize("main, job, sweep", [(wl2019, "_seg_iou_job", _sweep2019),
                                               (wl2020, "_gaze_metric_job", _sweep2020)], ids=["ist2019", "ist2020"])
def test_a_failing_metric_job_fails_the_sweep_and_stops_its_worker(main, job, sweep, tmp_path, monkeypatch,
                                                                      one_thread):
    def fail(*args):
        raise RuntimeError("metric job failed")

    monkeypatch.setattr(main, job, fail)
    before = set(threading.enumerate())
    logger = MetricLogger("t", "fails", out_dir=str(tmp_path / "logs"))
    with pytest.raises(RuntimeError, match="metric job failed"):
        sweep(f"{tmp_path}/", logger)
    logger.finish()
    assert [t.name for t in threading.enumerate() if t not in before] == []
