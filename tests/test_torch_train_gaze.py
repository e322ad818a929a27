"""CPU parity of the port's gaze-training slice against the JAX package:
the cosine embedding loss, one training step of each estimator, the
synthetic features, the checkpoint round trips and ``--resume``.

Tolerances: the loss 1e-6; the training step's gradients within ``1e-4 *
max|g|`` per parameter leaf (ResNet50's 53 float32 convs summed in another
order); the parameters after one Adam step within ``1e-5 * max|p|`` per
leaf for GazeEstimator1 and within ``1e-5`` of each leaf's norm for
GazeEstimator2 (Adam's first step moves every element by ``lr * g / (|g| +
eps)``, so an element whose gradient is zero to within rounding can move
by ``lr`` either way); landmarks within ``1e-3 * max(H, W)`` as in
``tests/test_torch_gaze.py``; frames and gaze vectors exact; the resumed
run bit for bit.
"""

import shutil

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from iris_style_transfer_tpu.data import synthetic as jsyn
from iris_style_transfer_tpu.models import GazeEstimator1 as JG1
from iris_style_transfer_tpu.models import GazeEstimator2 as JG2
from iris_style_transfer_tpu.ops import metrics as jmetrics
from iris_style_transfer_tpu.workloads import gaze_estimation as jwl

from iris_style_transfer_tpu_torch.data import synthetic as tsyn
from iris_style_transfer_tpu_torch.models.port import from_jax, to_jax
from iris_style_transfer_tpu_torch.ops import metrics as tmetrics
from iris_style_transfer_tpu_torch.runtime import checkpoint as tckpt
from iris_style_transfer_tpu_torch.workloads import gaze_estimation as wl
from iris_style_transfer_tpu_torch.workloads import iris_classification as wl2019

H, W = 48, 64


def _fill(shapes, rng):
    def leaf(path, s):
        name = getattr(path[-1], "key", "")
        if name == "w":
            return (rng.standard_normal(s.shape) * np.sqrt(2.0 / np.prod(s.shape[:-1]))).astype(np.float32)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        return (rng.standard_normal(s.shape) * 0.1).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _rel(got, want):
    """Per leaf: (max|got - want| / max|want|, ||got - want|| / ||want||)."""
    out = []
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want), strict=True):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        d = np.abs(g - w)
        out.append((d.max() / max(np.abs(w).max(), 1e-30), np.linalg.norm(d) / max(np.linalg.norm(w), 1e-30)))
    return np.array(out)


def test_cosine_embedding_loss_matches_jax():
    rng = np.random.default_rng(0)
    a, b = rng.standard_normal((2, 9, 3)).astype(np.float32)
    a[3] = 0.0  # a zero row: the norm product is floored at eps
    want = float(jmetrics.cosine_embedding_loss(jnp.asarray(a), jnp.asarray(b)))
    got = float(tmetrics.cosine_embedding_loss(torch.from_numpy(a), torch.from_numpy(b)))
    assert abs(got - want) <= 1e-6


def _one_step(estimator, jparams, x, y, lr):
    """JAX: (grads, params after one optax.adam step), dropout off."""

    def loss_fn(p):
        if estimator == 1:
            o = JG1.apply(p, jnp.asarray(x))
        else:
            o = JG2.apply(p, jnp.asarray(x), extract_feature=True)
        return jmetrics.cosine_embedding_loss(o, jnp.asarray(y))

    g = jax.grad(loss_fn)(jparams)
    opt = optax.adam(lr)
    upd, _ = opt.update(g, opt.init(jparams), jparams)
    return jax.tree.map(np.asarray, g), jax.tree.map(np.asarray, optax.apply_updates(jparams, upd))


@pytest.mark.parametrize("estimator", [1, 2])
def test_one_training_step_matches_optax(estimator):
    rng = np.random.default_rng(estimator)
    if estimator == 1:
        shapes = jax.eval_shape(JG1.init, jax.random.PRNGKey(0))
        x = rng.standard_normal((4, 19)).astype(np.float32)
    else:
        shapes = jax.eval_shape(lambda k: JG2.init(k, extract_feature=True), jax.random.PRNGKey(0))
        x = rng.uniform(size=(2, 64, 64, 1)).astype(np.float32)
    jp = _fill(shapes, np.random.default_rng(10 + estimator))
    y = rng.standard_normal((len(x), 3)).astype(np.float32)
    y /= np.linalg.norm(y, axis=1, keepdims=True)
    want_g, want_p = _one_step(estimator, jp, x, y, 1e-4)

    params = from_jax(jp)
    opt = torch.optim.Adam(tckpt.trainable(params), lr=1e-4)
    train_step, _ = wl.make_steps(estimator, torch.float32)
    train_step(params, opt, torch.from_numpy(x), torch.from_numpy(y), None)
    g_err = _rel(to_jax(jax.tree.map(lambda t: t.grad, params)), want_g)
    p_err = _rel(to_jax(params), want_p)
    assert g_err[:, 0].max() <= 1e-4, g_err
    assert p_err[:, 0 if estimator == 1 else 1].max() <= 1e-5, p_err


def _tiny_eye_batch(n, *args, **kwargs):
    return tsyn.synthetic_eye_batch(n, height=H, width=W, seed=kwargs.get("seed", 0), gaze=kwargs.get("gaze", False))


@pytest.mark.parametrize("estimator", [1, 2])
def test_synthetic_gaze_features_match_jax(monkeypatch, estimator):
    monkeypatch.setattr(jwl, "synthetic_eye_batch", lambda n, *a, **k: jsyn.synthetic_eye_batch(
        n, height=H, width=W, seed=k.get("seed", 0), gaze=k.get("gaze", False)))
    monkeypatch.setattr(wl, "synthetic_eye_batch", _tiny_eye_batch)
    feats_j, gaze_j = jwl._synthetic_gaze(6, estimator, seed=3)
    feats, gaze = wl._synthetic_gaze(6, estimator, seed=3)
    np.testing.assert_array_equal(gaze, gaze_j)
    if estimator == 2:
        np.testing.assert_array_equal(feats, feats_j)
    else:
        assert feats.shape == (6, 19) and np.abs(feats_j).max() > 0
        np.testing.assert_allclose(feats, feats_j, rtol=0, atol=1e-3 * max(H, W))


def test_to_jax_inverts_from_jax_for_resnet_trees():
    shapes = jax.eval_shape(lambda k: JG2.init(k, extract_feature=True), jax.random.PRNGKey(0))
    tree = _fill(shapes, np.random.default_rng(0))
    back = to_jax(from_jax(tree))
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)


def test_resume_repeats_the_straight_run_bit_for_bit(tmp_path):
    """One step, save, restore into fresh params and optimizer, one more
    step: the same params and Adam state as two straight steps (dropout on,
    its generator seeded per step as the mains do)."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((2, 8, 19)).astype(np.float32))
    y = torch.nn.functional.normalize(torch.from_numpy(rng.standard_normal((2, 8, 3)).astype(np.float32)), dim=-1)
    train_step, _ = wl.make_steps(1)

    def fresh():
        params = wl.GazeEstimator1.init(torch.Generator().manual_seed(0))
        return params, torch.optim.Adam(tckpt.trainable(params), lr=1e-3)

    def step(params, opt, i):
        train_step(params, opt, x[i], y[i], torch.Generator().manual_seed(100 + i))

    straight, opt_s = fresh()
    step(straight, opt_s, 0)
    step(straight, opt_s, 1)

    params, opt = fresh()
    step(params, opt, 0)
    tckpt.save_training_state(str(tmp_path), 1, params, opt)
    resumed, opt_r = fresh()
    assert tckpt.resume_training_state(str(tmp_path), resumed, opt_r) == 1
    step(resumed, opt_r, 1)
    for a, b in zip(jax.tree.leaves(resumed), jax.tree.leaves(straight)):
        assert torch.equal(a, b)
    for a, b in zip(tckpt.adam_state(opt_r), tckpt.adam_state(opt_s)):
        assert all(torch.equal(a[k], b[k]) for k in a)
    assert tckpt.resume_training_state(str(tmp_path / "none"), *fresh()) == 0


def test_training_mains_refuse_what_they_cannot_run(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    (tmp_path / "data" / "openeds2019").mkdir(parents=True)
    (tmp_path / "data" / "openeds2020" / "openEDS2020-GazePrediction").mkdir(parents=True)
    # an existing data directory is read: one without the tree's files
    # fails as the JAX mains' do, on the first file they look for
    missing = {wl.main: "train/sequences", wl2019.main: "OpenEDS_train_userID_mapping_to_images.json"}
    for main in (wl.main, wl2019.main):
        with pytest.raises(SystemExit, match="CUDA is not available"):
            main([])
        if main is wl2019.main:  # the gaze main takes the flag (tests/test_torch_mesh_defaults.py)
            with pytest.raises(SystemExit, match="ROADMAP"):
                main(["--device", "cpu", "--model_parallel", "2"])
        with pytest.raises(FileNotFoundError, match=missing[main]):
            main(["--device", "cpu", "--data_dir", str(tmp_path / "data")])
    with pytest.raises(SystemExit, match="96 or less"):
        wl.main(["--device", "cpu", "--data_dir", str(tmp_path / "nodata")])  # the JAX default bs 128


@pytest.mark.parametrize("main", ["gaze1", "gaze2", "classification"])
def test_training_mains_run_from_data_trees(tmp_path, monkeypatch, main):
    """Each trainer reads a fake tree: estimator 1 on landmarks that B7
    extracts from the frames, estimator 2 on frames streamed per epoch
    (padded evaluation batches masked by ``valid``), the classifier on the
    OpenEDS2019 frames."""
    from iris_style_transfer_tpu_torch.data import fake_openeds

    monkeypatch.chdir(tmp_path)
    data = str(tmp_path / "data")
    argv = ["-E", "1", "-bs", "4", "-SP", "-1", "--data_dir", data, "--device", "cpu", "--compute_dtype", "float32"]
    if main == "classification":
        fake_openeds.write_openeds2019(data, users=(2, 1, 1), frames_per_user=8, height=H, width=W)
        log = wl2019.main(argv)
        keys = ("train/c1/accu", "train/c2/loss", "test/c1/f1", "train/steps_per_sec")
    else:
        # 2 x 5 training frames: two steps at bs 4, the last two dropped;
        # 5 validation frames: one full batch and one padded
        fake_openeds.write_openeds2020(data, sequences=(2, 1, 0), frames_per_sequence=5, height=H, width=W)
        calls = []
        real = wl.stream_openeds2020
        monkeypatch.setattr(wl, "stream_openeds2020", lambda *a, **k: calls.append(k) or real(*a, **k))
        log = wl.main(["-estimator", main[-1], *argv])
        keys = ("train/loss", "train/degree_distance", "valid/loss", "valid/degree_distance", "train/steps_per_sec")
        if main == "gaze2":  # three lrs x (one training epoch + one validation pass), all streamed
            assert len(calls) == 6 and calls[0] == {"shuffle_seed": 42, "drop_remainder": True}
        else:
            assert not calls
    for key in keys:
        assert key in log and np.isfinite(log[key]), key


def _run_mains(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(wl, "synthetic_eye_batch", _tiny_eye_batch)
    monkeypatch.setattr(wl2019, "synthetic_openeds2019", lambda n_per_user=8, num_users=8, seed=0:
                        tsyn.synthetic_openeds2019(6, 3, seed=seed, height=H, width=W))
    return str(tmp_path / "nodata")


@pytest.mark.slow
@pytest.mark.parametrize("estimator", ["1", "2"])
def test_gaze_main_runs_and_resumes_on_cpu(tmp_path, monkeypatch, estimator):
    nodata = _run_mains(tmp_path, monkeypatch)
    argv = ["-bs", "16", "-SP", "1", "-estimator", estimator, "--data_dir", nodata, "--device", "cpu"]
    log = wl.main(["-E", "1", *argv])
    for key in ("train/loss", "train/radian_distance", "train/degree_distance", "valid/loss",
                "valid/degree_distance", "train/steps_per_sec"):
        assert key in log and np.isfinite(log[key]), key
    np.testing.assert_allclose(log["valid/degree_distance"], np.degrees(log["valid/radian_distance"]), rtol=1e-5)
    ckpts = sorted((tmp_path / "saved" / "checkpoints").glob(f"gaze_estimator{estimator}_lr_*"))
    assert len(ckpts) == 3 and all((c / "state_00000001.npz").exists() for c in ckpts)
    log2 = wl.main(["-E", "2", "--resume", "--test", *argv])  # continues each lr past epoch 1
    assert "test/degree_distance" in log2
    assert all((c / "step_00000002.npz").exists() for c in ckpts)
    shutil.rmtree(tmp_path / "saved")  # ResNet50 checkpoints: about 0.4 GB per lr and epoch


@pytest.mark.slow
@pytest.mark.parametrize("freeze", ["--freeze_vgg", "--no-freeze_vgg"])
def test_classification_main_runs_and_resumes_on_cpu(tmp_path, monkeypatch, freeze):
    nodata = _run_mains(tmp_path, monkeypatch)
    argv = ["-bs", "4", "-SP", "1", "--data_dir", nodata, "--compute_dtype", "float32", "--device", "cpu", freeze]
    log = wl2019.main(["-E", "1", *argv])
    for key in ("train/c1/accu", "train/c2/loss", "test/c1/f1", "test/c2/mcc", "test/c1/auc", "train/steps_per_sec"):
        assert key in log and np.isfinite(log[key]), key
    ckpt = tmp_path / "saved" / "checkpoints" / "iris_classification"
    assert (ckpt / "step_00000001.npz").exists() and (ckpt / "state_00000001.npz").exists()
    log2 = wl2019.main(["-E", "2", "--resume", *argv])
    assert "test/c1/accu" in log2 and (ckpt / "step_00000002.npz").exists()
    shutil.rmtree(tmp_path / "saved")  # Classifier1's fc0 alone is 411 MB per file, 1.2 GB with Adam's moments
