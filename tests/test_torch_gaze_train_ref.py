"""The port's estimator-2 training step against the benchmark's plain
reference (``benchmark/reference/gaze_train.py``), at a small size on the
CPU with the benchmark's seeded weights, and the gaze main's own loop on
caller-given splits.

The step's records are the benchmark's own: ``benchmark/entries/
gaze2train.py``'s ``Taps`` stand in for the main's ``make_steps``, the
layers' ``block_dropout`` and the estimators' ``ResNet50``, and keep, at
the steps they are armed for, the parameters and Adam state the step
found, its dropout masks, loss, features and their gradient, its
gradient, and the parameters it left.

Tolerances, float32 on both sides, two intra-op threads: the loss 1e-5
relative; the gradient within 1e-4 relative L2 as a whole and 3e-3 leaf
by leaf (ResNet50's 53 convolutions and their batchnorm summed in another
order: the whole reads up to 6e-7, and a leaf whose gradient nearly
cancels over the batch's pixels, a batchnorm scale or variance of the
second step, up to 9.4e-5 of its own size; with one thread other
convolution paths round the twin's flat regions apart, where the 3x3
max-pool's one winner then moves, and the whole reads up to 1.4e-5);
Adam's updates within 1e-5 relative L2 (the parameters' float32 rounding
of the same update).  The reference's blocks add up to its whole batch
within the gradient's tolerances.
"""

import os

import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

from benchmark import harness, twin, weights
from benchmark.reference import gaze_train as ref

from iris_style_transfer_tpu_torch.runtime import profiler
from iris_style_transfer_tpu_torch.runtime.config import WorkloadConfig
from iris_style_transfer_tpu_torch.workloads import gaze_estimation as wl
from iris_style_transfer_tpu_torch.runtime.checkpoint import trainable

SEED = 2**31 + 11
N, H, W = 4, 64, 96
LR = 1e-3  # larger than the cell's, so that the second step's state differs visibly from the first's


def _params(seed=SEED):
    (head,) = weights.mlp_heads(seed, [(2048, 64, 64, 3)], "cpu")
    return {"head": head, "resnet": weights.resnet50(seed, "cpu")}


def _batch(index: int, n: int = N, h: int = H, w: int = W):
    b = twin.eyes(SEED, index, n, 8, h, w, gaze=True, device="cpu")
    return b["frames"], b["gaze"]


@pytest.fixture(autouse=True)
def two_threads():
    """Two intra-op threads, which the tolerances were read at: the file
    runs beside the other test workers, whose two-rank mains wait on a
    join bound."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def taps():
    entry = harness.load_module(os.path.join(harness.BENCH_DIR, "entries", "gaze2train.py"),
                                "benchmark.entries.gaze2train")
    t = entry.Taps()
    yield t
    t.close()


def _gaps(got: torch.Tensor, want: torch.Tensor, leaves) -> tuple[float, float]:
    """Relative L2 gaps of flat gradients in the order of ``leaves``: the
    whole, and the largest leaf's."""
    got, want = got.double(), want.double()
    worst, at = 0.0, 0
    for t in leaves:
        g, w = got[at:at + t.numel()], want[at:at + t.numel()]
        at += t.numel()
        worst = max(worst, float((g - w).norm() / w.norm().clamp_min(1e-30)))
    return float((got - want).norm() / want.norm()), worst


def _close(got: torch.Tensor, want: torch.Tensor, leaves) -> bool:
    whole, leaf = _gaps(got, want, leaves)
    return whole <= 1e-4 and leaf <= 3e-3


def _flat(ts) -> torch.Tensor:
    return torch.cat([t.detach().reshape(-1).float() for t in ts])


@pytest.mark.parametrize("dropout", [True, False], ids=["dropout", "no_dropout"])
def test_train_step_matches_reference(taps, dropout):
    """Two steps of the port's ``train_step``: each loss and every leaf's
    gradient against the reference at the parameters the step found, and
    each Adam update against the reference's Adam from the step's own
    gradient and state."""
    torch.manual_seed(0)
    params = pytree.tree_map(torch.clone, _params())
    opt = torch.optim.Adam(trainable(params), lr=LR)
    leaves, spec = pytree.tree_flatten(_params())
    taps.arm({0, 1}, sum(t.numel() for t in leaves), (N, H, W, 1), False)
    train_step, _ = wl.make_steps(2, torch.float32)
    for i in range(2):
        x, y = _batch(i)
        gen = torch.Generator().manual_seed(100 + i) if dropout else None
        train_step(params, opt, x, y, gen)
    taps.finish(0)
    for k in (0, 1):
        s = taps.steps[k]
        assert len(s["masks"]) == (2 if dropout else 0)
        tree = pytree.tree_unflatten([p.view(t.shape) for p, t in zip(s["before"].split([t.numel() for t in leaves]),
                                                                         leaves)], spec)
        loss, grads, feats, up = ref.loss_and_grad(tree, s["x"], s["y"], s["masks"])
        assert abs(s["loss"] - loss) <= 1e-5 * abs(loss)
        assert _close(s["grad"], _flat(grads), leaves), _gaps(s["grad"], _flat(grads), leaves)
        # in two stages, at the port's own features and its gradient with respect to them
        head, head_up = ref.head_grad(tree["head"], s["feats"], s["y"], s["masks"])
        trunk, ref_feats = ref.trunk_grad(tree["resnet"], s["x"], s["upstream"])
        assert _close(s["grad"], _flat(head + trunk), leaves), _gaps(s["grad"], _flat(head + trunk), leaves)
        assert float((s["feats"] - feats).abs().max()) <= 1e-5 * float(feats.abs().max())
        assert float((s["upstream"] - up).norm()) <= 1e-4 * float(up.norm())
        assert float((s["upstream"] - head_up).norm()) <= 1e-4 * float(head_up.norm())
        zeros = torch.zeros_like(s["grad"])
        m, v = (zeros if s[key] is None else s[key] for key in ("m", "v"))
        assert s["t"] == k
        want = (s["before"] + ref.adam_update(s["grad"], m, v, s["t"], LR)).double() - s["before"].double()
        got = s["after"].double() - s["before"].double()
        assert float((got - want).norm() / want.norm()) <= 1e-5
    assert torch.equal(taps.steps[1]["before"], taps.steps[0]["after"])


@pytest.mark.parametrize("block", [1, 3])
def test_blocked_and_staged_gradients_equal_whole_batch(block):
    """The reference's gradient in blocks, and in two stages (the head's
    at the features, the trunk's from the gradient with respect to
    them), is its whole batch's."""
    params = _params()
    x, y = _batch(7)
    masks = [torch.rand(N, 64, generator=torch.Generator().manual_seed(i)) < 0.5 for i in range(2)]
    loss, whole, feats, up = ref.loss_and_grad(params, x, y, masks, block=N)
    loss_b, blocked, _, _ = ref.loss_and_grad(params, x, y, masks, block=block)
    trunk, _ = ref.trunk_grad(params["resnet"], x, up, block=block)
    head, head_up = ref.head_grad(params["head"], feats, y, masks)
    staged = head + trunk
    assert abs(loss_b - loss) <= 1e-6 * abs(loss)
    assert float((head_up - up).norm()) <= 1e-6 * float(up.norm())
    assert _close(_flat(blocked), _flat(whole), pytree.tree_leaves(params))
    assert _close(_flat(staged), _flat(whole), pytree.tree_leaves(params))


def _cfg(**kw):
    return WorkloadConfig(**{"seed": 5, "epochs": 1, "bs": 128, "save_period": 0, "estimator": 2,
                             "compute_dtype": "float32", **kw})


def test_main_loop_runs_caller_splits_above_96_frames(tmp_path, monkeypatch):
    """Estimator 2 at bs 128 (above the twin's 96 frames) on 256 training
    frames (two steps) and 160 validation frames (one full batch and one
    padded), under the profiler: finite ``train/`` and ``valid/`` metrics,
    and the epoch's spans, one of each a step, one load more, one eval a
    validation batch, one metrics."""
    from torch.profiler import ProfilerActivity, profile

    monkeypatch.chdir(tmp_path)
    train = tuple(np.concatenate(a) for a in zip(*[(f.numpy(), g.numpy()) for f, g in
                                                  (_batch(i, 128, 32, 32) for i in range(2))]))
    valid = tuple(a[:160] for a in (np.concatenate([train[0], train[0]]), np.concatenate([train[1], train[1]])))
    with profile(activities=[ProfilerActivity.CPU]):
        log = wl.gaze_estimation(_cfg(), torch.device("cpu"), lrs=(1e-5,), splits={"train": train, "valid": valid},
                                 start_params=_params())
    for key in ("train/loss", "train/degree_distance", "valid/loss", "valid/degree_distance", "train/steps_per_sec"):
        assert key in log and np.isfinite(log[key]), key
    names = [s.name for s in profiler.spans() if s.name.startswith("gaze.")]
    assert {n: names.count(n) for n in set(names)} == {"gaze.load": 3, "gaze.grad": 2, "gaze.adam": 2,
                                                        "gaze.eval": 2, "gaze.metrics": 1}


@pytest.mark.parametrize("splits,match", [
    ({"train": 96, "valid": 8}, "96 training frames give no step at -bs 128.*caller-given splits of at least 128"),
    ({"train": 128}, "the caller-given splits lack valid"),
], ids=["too_few_frames", "no_validation_split"])
def test_caller_splits_the_main_refuses(tmp_path, monkeypatch, splits, match):
    monkeypatch.chdir(tmp_path)
    arrays = {k: (np.zeros((n, 8, 8, 1), np.uint8), np.zeros((n, 3), np.float32)) for k, n in splits.items()}
    with pytest.raises(SystemExit, match=match):
        wl.gaze_estimation(_cfg(), torch.device("cpu"), lrs=(1e-5,), splits=arrays)
