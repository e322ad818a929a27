"""The 2020 gaze-preservation batch body on the CPU against the same
composition of JAX functions, and the 2020 main's contracts.

The port runs ``iris_style_transfer_openeds2020`` itself on three twin
frames at 48 x 64 (padded to one batch of 4) with 2 NST closures in
float32; the JAX side composes the JAX package's B7 apply, both
estimators, the iris extraction, its production NST program and the
composite on the same quantized frames and parameters.  Tolerances, as
the 2019 slice test's: the NST loss histories rtol 1e-3; B7 labels
>= 99.5% equal; the degree distances within 0.01 degrees (they agree to
about 2e-5 here; a pixel that flips class would move a landmark by about
1/area of its mask).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from iris_style_transfer_tpu.models import EfficientNet as JE
from iris_style_transfer_tpu.models import GazeEstimator1 as JG1
from iris_style_transfer_tpu.models import GazeEstimator2 as JG2
from iris_style_transfer_tpu.models import VGG19 as JVGG
from iris_style_transfer_tpu.ops import metrics as jmetrics
from iris_style_transfer_tpu.ops.image import gray_to_rgb as j_gray_to_rgb
from iris_style_transfer_tpu.pipelines import iris as jiris
from iris_style_transfer_tpu.transfer.nst import cached_nst_program as j_cached_nst_program

from iris_style_transfer_tpu_torch.data import synthetic as tsyn
from iris_style_transfer_tpu_torch.models.port import from_jax
from iris_style_transfer_tpu_torch.runtime import MetricLogger
from iris_style_transfer_tpu_torch.runtime.config import WorkloadConfig
from iris_style_transfer_tpu_torch.workloads import ist_openeds2020 as wl

H, W = 48, 64


def _fill(shapes, rng, gain=2.0):
    """Random values for a JAX parameter tree: conv and linear weights of
    variance gain / fan_in (B7 takes gain 1: at He scale 55 random blocks
    amplify float32 rounding into label flips), batchnorm off the identity."""

    def leaf(path, s):
        name = getattr(path[-1], "key", "")
        if name == "w":
            return (rng.standard_normal(s.shape) * np.sqrt(gain / np.prod(s.shape[:-1]))).astype(np.float32)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        return (rng.standard_normal(s.shape) * 0.1).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _jax_batch_body(eff, g1, g2, vgg, frames_u8, labels, valid, s_iris, epochs, stats_taps="auto"):
    """The JAX workload's per-batch programs, unchunked."""
    f32 = jnp.float32
    c = jnp.asarray(frames_u8).astype(f32) / 255.0
    apply = jax.jit(lambda p, x: JE.apply(p, x, compute_dtype=f32))
    est1 = jax.jit(lambda p, s: JG1.apply(p, s, extract_feature=True))
    est2 = jax.jit(lambda p, x: JG2.apply(p, j_gray_to_rgb(x), extract_feature=True, compute_dtype=f32))

    segs = apply(eff, c)
    pre = (est1(g1, segs), est2(g2, c))
    irises, masks, bboxes = jax.jit(jiris.extract_iris_batch)(c, segs)
    nst = j_cached_nst_program(epochs, 1.0, 1.0, "float32", stats_taps=stats_taps)
    s_batch = jnp.broadcast_to(j_gray_to_rgb(jnp.asarray(s_iris))[None], irises.shape)
    res = nst(vgg, irises, s_batch)
    new = jax.jit(jiris.composite_batch)(c, res.x, masks, bboxes)
    segs2 = apply(eff, new)
    post = (est1(g1, segs2), est2(g2, new))
    deg = {}
    for phase, preds in (("pre", pre), ("post", post)):
        for i, p in zip("12", preds):
            _, d = jmetrics.angular_distance(jnp.asarray(np.asarray(p)[valid]), jnp.asarray(labels))
            deg[f"validation//{phase}/degree_distance{i}"] = float(d.mean())
    return deg, res, np.asarray(segs)


@pytest.fixture(scope="module")
def params():
    rng = np.random.default_rng(0)
    eff = _fill(jax.eval_shape(JE.init, jax.random.PRNGKey(0)), rng, gain=1.0)
    # lean the head towards the iris class, so that every frame has an
    # iris region of 500-1500 pixels beside sclera and pupil to crop,
    # stylize and composite
    eff["head"]["b"] = eff["head"]["b"] + np.array([0.0, 0.0, 0.25, 0.0], np.float32)
    g1 = _fill(jax.eval_shape(JG1.init, jax.random.PRNGKey(1)), rng)
    g2 = _fill(jax.eval_shape(lambda k: JG2.init(k, extract_feature=True), jax.random.PRNGKey(2)), rng)
    vgg = jax.tree.map(np.asarray, jax.jit(JVGG.init)(jax.random.PRNGKey(0)))
    return eff, g1, g2, vgg


def test_batch_body_matches_jax(params, tmp_path, monkeypatch):
    _check_batch_body(params, tmp_path, monkeypatch, "auto")


def test_batch_body_with_stats_taps_matches_jax(params, tmp_path, monkeypatch):
    """``--stats_taps on``: the fused relu+stats taps on both sides."""
    _check_batch_body(params, tmp_path, monkeypatch, "on")


def _check_batch_body(params, tmp_path, monkeypatch, stats_taps):
    eff, g1, g2, vgg = params
    imgs, _, _, labels = tsyn.synthetic_eye_batch(3, H, W, seed=5, gaze=True)
    s_iris = np.random.default_rng(9).random((224, 224, 1)).astype(np.float32)

    captured = []
    real = wl.cached_nst_program

    def capture(*args):
        fn = real(*args)

        def run(*a):
            captured.append(fn(*a))
            return captured[-1]

        return run

    monkeypatch.setattr(wl, "cached_nst_program", capture)
    monkeypatch.chdir(tmp_path)
    cfg = WorkloadConfig(bs=4, compute_dtype="float32", stats_taps=stats_taps)
    te = from_jax(eff)
    logger = MetricLogger("t", "body", out_dir=str(tmp_path / "logs"))
    log = wl.iris_style_transfer_openeds2020(
        cfg, imgs, labels, te, from_jax(g1), from_jax(g2), from_jax(vgg), torch.from_numpy(s_iris),
        1.0, 1.0, 2, "validation/", f"{tmp_path}/", logger, torch.device("cpu"),
    )
    logger.finish()

    frames_u8 = np.round(np.concatenate([imgs, imgs[-1:]]) * 255.0).astype(np.uint8)  # the padded batch
    valid = np.array([True, True, True, False])
    want, res_j, segs_j = _jax_batch_body(eff, g1, g2, vgg, frames_u8, labels, valid, s_iris, 2, stats_taps)

    (res,) = captured
    np.testing.assert_allclose(res.s_loss_hist.numpy(), np.asarray(res_j.s_loss_hist), rtol=1e-3)
    np.testing.assert_allclose(res.c_loss_hist.numpy(), np.asarray(res_j.c_loss_hist), rtol=1e-3, atol=1e-10)
    segs = wl.EfficientNet.apply(te, torch.from_numpy(frames_u8).float() / 255.0).numpy()
    assert (segs == segs_j).mean() >= 0.995
    assert ((segs_j[:3] == 2).sum(axis=(1, 2)) >= 500).all()
    for key, v in want.items():
        assert abs(log[key] - v) <= 0.01, (key, log[key], v)
    for key in ("validation//c_loss", "validation//s_loss", "validation//stylized_images_per_min",
                "validation//pipeline_images_per_min", "validation//post/radian_distance2"):
        assert np.isfinite(log[key]), key
    np.testing.assert_allclose(log["validation//s_loss"], float(res_j.s_loss_hist[-1]), rtol=1e-3)
    assert np.load(tmp_path / "preds1_post.npy").shape == (3, 3)
    np.testing.assert_array_equal(np.load(tmp_path / "labels.npy"), labels)
    # the stylized irises were composited back: the post estimate moved
    assert log["validation//post/degree_distance2"] != log["validation//pre/degree_distance2"]


def test_main_refuses_what_it_cannot_run(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA is not available"):
        wl.main(["--device", "cuda"])
    with pytest.raises(SystemExit, match="ROADMAP"):
        wl.main(["--device", "cpu", "--model_parallel", "2"])
    (tmp_path / "data" / "openeds2020" / "openEDS2020-GazePrediction").mkdir(parents=True)
    with pytest.raises(SystemExit, match="ROADMAP"):
        wl.main(["--device", "cpu", "--data_dir", str(tmp_path / "data")])


@pytest.mark.slow
def test_main_runs_on_cpu(tmp_path, monkeypatch):
    """The 2020 main end to end on the synthetic twin (small frames)."""
    _run_main(tmp_path, monkeypatch, [])


@pytest.mark.slow
def test_main_runs_with_stats_taps_on_cpu(tmp_path, monkeypatch):
    """The same with ``--stats_taps on``, which the main once refused."""
    _run_main(tmp_path, monkeypatch, ["--stats_taps", "on"])


def _run_main(tmp_path, monkeypatch, extra):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(wl, "synthetic_eye_batch", lambda n, seed=0, gaze=False:
                        tsyn.synthetic_eye_batch(min(n, 6), H, W, seed=seed, gaze=gaze))
    argv = ["-bs", "4", "--nst_epochs", "2", "--data_dir", str(tmp_path / "nodata"), "--device", "cpu", *extra]
    results = wl.main(argv)
    log = results[("validation/", 1.0, 2)]
    for key in ("validation//pre/degree_distance1", "validation//pre/degree_distance2",
                "validation//post/degree_distance1", "validation//post/degree_distance2",
                "validation//c_loss", "validation//s_loss",
                "validation//stylized_images_per_min", "validation//pipeline_images_per_min"):
        assert key in log and np.isfinite(log[key]), key
    out = tmp_path / "saved" / "openeds2020" / "sw_1.0_epoch_2" / "validation"
    for name in ("gts.npy", "labels.npy", "preds2_post.npy", "done.json", "batch_0_new.png"):
        assert (out / name).exists(), name
    assert wl.main(argv) == {}  # the completed combo is skipped
