"""CPU parity of the port's 2020 gaze path pieces against the JAX package:
ResNet50, the batched landmark extractor, both gaze estimators, the
angular distance and the small ops the slice adds.

Parameter trees are shaped by the JAX ``init``s under ``jax.eval_shape``
and filled from a numpy generator.  Tolerances: ResNet50 features and the
estimators' outputs in float32 rtol 1e-3 of their scale (50 layers of
float32 convs summed in another order); landmarks atol 1e-3 of the pixel
scale max(H, W) (moment sums over the frame reduced in another order; the
ellipse angle of a nearly round mask is the least well conditioned
feature); angular distances and the small ops 1e-5.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from iris_style_transfer_tpu.models import GazeEstimator1 as JG1
from iris_style_transfer_tpu.models import GazeEstimator1Complicated as JG1C
from iris_style_transfer_tpu.models import GazeEstimator2 as JG2
from iris_style_transfer_tpu.models import ResNet50 as JResNet50
from iris_style_transfer_tpu.models import find_ellipse_features as j_find_ellipse_features
from iris_style_transfer_tpu.models import find_eye_corners as j_find_eye_corners
from iris_style_transfer_tpu.models import layers as jl
from iris_style_transfer_tpu.models.port import save_npz
from iris_style_transfer_tpu.ops import ellipse as jellipse
from iris_style_transfer_tpu.ops import image as jimg
from iris_style_transfer_tpu.ops import metrics as jmetrics

from iris_style_transfer_tpu_torch.data.synthetic import synthetic_eye_batch
from iris_style_transfer_tpu_torch.models import (GazeEstimator1, GazeEstimator1_complicated, GazeEstimator1Complicated,
                                                   GazeEstimator2, ResNet50, find_ellipse_features, find_eye_corners,
                                                   load_pretrained)
from iris_style_transfer_tpu_torch.models import layers as tl
from iris_style_transfer_tpu_torch.models.port import from_jax
from iris_style_transfer_tpu_torch.models.pretrained import pretrained_path
from iris_style_transfer_tpu_torch.ops import ellipse as tellipse
from iris_style_transfer_tpu_torch.ops import image as timg
from iris_style_transfer_tpu_torch.ops import metrics as tmetrics


def _fill(shapes, rng):
    def leaf(path, s):
        name = getattr(path[-1], "key", "")
        if name == "w":
            return (rng.standard_normal(s.shape) * np.sqrt(2.0 / np.prod(s.shape[:-1]))).astype(np.float32)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        return (rng.standard_normal(s.shape) * 0.1).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@pytest.fixture(scope="module")
def g2_params():
    shapes = jax.eval_shape(lambda k: JG2.init(k, extract_feature=True), jax.random.PRNGKey(0))
    return _fill(shapes, np.random.default_rng(1))


@pytest.fixture(scope="module")
def images():
    return np.random.default_rng(2).random((2, 64, 96, 3)).astype(np.float32)


def _close(got, want, rtol=1e-3):
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * np.abs(want).max())


def test_resnet50_features_match_jax(g2_params, images):
    jp = g2_params["resnet"]
    want = np.asarray(jax.jit(JResNet50.apply)(jp, jnp.asarray(images)))
    got = ResNet50.apply(from_jax(jp), torch.from_numpy(images))
    assert got.shape == (2, 2048) and got.dtype == torch.float32
    _close(got.numpy(), want)


def test_resnet50_weights_load_from_jax_npz(tmp_path, g2_params):
    """load_pretrained reads the JAX package's npz format for the 2020
    weight kinds; ``resnet50`` and ``efficientnet_unet`` use the JAX file
    names and, with no npz in the repo, fall back to the seeded init."""
    path = os.path.join(tmp_path, "resnet50.npz")
    save_npz(path, g2_params["resnet"])
    tp = load_pretrained("resnet50", path)
    np.testing.assert_array_equal(tp["layer3"][2]["conv2"]["w"].numpy(),
                                  np.transpose(g2_params["resnet"]["layer3"][2]["conv2"]["w"], (3, 2, 0, 1)))
    np.testing.assert_array_equal(tp["layer4"][0]["downsample"]["bn"]["mean"].numpy(),
                                  g2_params["resnet"]["layer4"][0]["downsample"]["bn"]["mean"])
    for kind in ("resnet50", "efficientnet_unet"):
        assert pretrained_path(kind) is None
        assert load_pretrained(kind, "", lambda: "seeded") == "seeded"
    with pytest.raises(FileNotFoundError):
        load_pretrained("efficientnet_unet", os.path.join(tmp_path, "missing.npz"))


def _segs_with_missing_classes():
    _, segs, _ = synthetic_eye_batch(6, 96, 128, seed=7)
    segs[1][segs[1] == 3] = 2  # no pupil
    segs[2][:] = 0  # background only
    segs[3][segs[3] == 1] = 0  # no sclera
    return segs


def test_extract_eye_landmarks_matches_jax_vmap():
    segs = _segs_with_missing_classes()
    want = np.asarray(jax.vmap(jellipse.extract_eye_landmarks)(jnp.asarray(segs)))
    got = tellipse.extract_eye_landmarks(torch.from_numpy(segs))
    assert got.shape == (6, 19) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-3 * 128)
    got = got.numpy()
    assert not got[2].any()  # no class at all: every feature is 0
    assert not got[1, [0, 1, 2, 3, 4, 17, 18]].any()  # no pupil: its ellipse and position
    assert not got[3, 10:19].any()  # no sclera: corners, width, height, ratio, position
    assert got[0, [2, 3, 7, 8, 14, 15]].all()  # both ellipses fitted, eye extents found


def test_fit_ellipse_and_eye_corners_match_jax():
    rng = np.random.default_rng(3)
    yy, xx = np.mgrid[0:60, 0:80]
    masks = np.stack([((xx - 40) / 25.0) ** 2 + ((yy - 28) / 12.0) ** 2 <= 1,
                      rng.random((60, 80)) > 0.7,
                      np.zeros((60, 80), bool)])
    got = tellipse.fit_ellipse_mask(torch.from_numpy(masks)).numpy()
    want = np.asarray(jax.vmap(jellipse.fit_ellipse_mask)(jnp.asarray(masks)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3 * 80)
    np.testing.assert_allclose(got[0, :4], [40, 28, 50, 24], rtol=0.02)  # full axes 2a, 2b
    got_c = tellipse.eye_corners(torch.from_numpy(masks)).numpy()
    np.testing.assert_array_equal(got_c, np.asarray(jax.vmap(jellipse.eye_corners)(jnp.asarray(masks))))
    # select_largest: the ellipse, plus a second, smaller blob that it drops
    two = masks.copy()
    two[0] |= ((xx - 72) / 5.0) ** 2 + ((yy - 52) / 4.0) ** 2 <= 1
    got_l = tellipse.fit_ellipse_mask(torch.from_numpy(two), select_largest=True).numpy()
    want_l = np.asarray(jax.vmap(jellipse.fit_ellipse_mask, (0, None))(jnp.asarray(two), True))
    np.testing.assert_allclose(got_l, want_l, rtol=1e-5, atol=1e-3 * 80)
    np.testing.assert_allclose(got_l[0], got[0], rtol=1e-6)  # the small blob is ignored
    assert not np.allclose(tellipse.fit_ellipse_mask(torch.from_numpy(two))[0].numpy(), got[0])


def test_find_ellipse_features_and_eye_corners_match_jax():
    """The one-mask host helpers: Python numbers as the JAX helpers give
    them (floats within the ellipse tolerance above, ints exact), all None
    on an invalid fit or an empty mask; numpy and tensor inputs alike."""
    yy, xx = np.mgrid[0:60, 0:80]
    ell = ((xx - 40) / 25.0) ** 2 + ((yy - 28) / 12.0) ** 2 <= 1
    two = ell | (((xx - 72) / 5.0) ** 2 + ((yy - 52) / 4.0) ** 2 <= 1)
    for mask in (ell, two):
        for largest in (True, False):
            got = find_ellipse_features(mask, largest)
            want = j_find_ellipse_features(mask, largest)
            assert all(isinstance(v, float) for v in got)
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3 * 80)
        np.testing.assert_allclose(find_ellipse_features(torch.from_numpy(mask)), find_ellipse_features(mask))
    np.testing.assert_allclose(find_ellipse_features(two), find_ellipse_features(ell), rtol=1e-6)  # default: largest
    tiny = np.zeros((60, 80), bool)
    tiny[3, 3:6] = True  # 3 pixels: under min_pixels
    assert find_ellipse_features(tiny) == j_find_ellipse_features(tiny) == (None,) * 5
    got = find_eye_corners(two)
    assert got == j_find_eye_corners(two) and all(isinstance(v, int) for v in got)
    assert find_eye_corners(np.zeros((60, 80), bool)) == j_find_eye_corners(np.zeros((60, 80), bool)) == (None,) * 4


def test_gaze_estimator1_complicated_matches_jax():
    """Eval mode, float32, (2, 48, 64) segmaps with their landmarks given
    and extracted; the same params through ``from_jax``; outputs within
    rtol 1e-3 of their scale (float32 convs summed in another order)."""
    rng = np.random.default_rng(8)
    jp = _fill(jax.eval_shape(JG1C.init, jax.random.PRNGKey(0)), rng)
    tp = from_jax(jp)
    assert GazeEstimator1_complicated is GazeEstimator1Complicated
    segs = synthetic_eye_batch(2, 48, 64, seed=9)[1]
    lm = rng.standard_normal((2, 19)).astype(np.float32) * 10
    want = np.asarray(JG1C.apply(jp, jnp.asarray(segs), jnp.asarray(lm)))
    got = GazeEstimator1Complicated.apply(tp, torch.from_numpy(segs), torch.from_numpy(lm))
    assert got.shape == (2, 3) and got.dtype == torch.float32
    _close(got.numpy(), want)
    want = np.asarray(JG1C.apply(jp, jnp.asarray(segs), extract_feature=True))
    _close(GazeEstimator1Complicated.apply(tp, torch.from_numpy(segs), extract_feature=True).numpy(), want)
    tree = GazeEstimator1Complicated.init(torch.Generator().manual_seed(0))
    shapes = jax.tree_util.tree_map(np.shape, from_jax(jax.tree_util.tree_map(np.asarray, JG1C.init(jax.random.PRNGKey(0)))))
    assert jax.tree_util.tree_map(lambda t: tuple(t.shape), tree) == jax.tree_util.tree_map(tuple, shapes)
    drop = GazeEstimator1Complicated.apply(tp, torch.from_numpy(segs), torch.from_numpy(lm), train=True,
                                           gen=torch.Generator().manual_seed(1))
    assert not torch.allclose(drop, got)  # dropout on in training


def test_gaze_estimator1_matches_jax():
    rng = np.random.default_rng(4)
    jp = _fill(jax.eval_shape(JG1.init, jax.random.PRNGKey(0)), rng)
    tp = from_jax(jp)
    lm = rng.standard_normal((5, 19)).astype(np.float32) * 20
    _close(GazeEstimator1.apply(tp, torch.from_numpy(lm)).numpy(), np.asarray(JG1.apply(jp, jnp.asarray(lm))),
           rtol=1e-5)
    segs = _segs_with_missing_classes()
    want = np.asarray(jax.jit(lambda p, s: JG1.apply(p, s, extract_feature=True))(jp, jnp.asarray(segs)))
    got = GazeEstimator1.apply(tp, torch.from_numpy(segs), extract_feature=True).numpy()
    _close(got, want)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)


def test_gaze_estimator2_matches_jax(g2_params, images):
    tp = from_jax(g2_params)
    feats = np.random.default_rng(5).standard_normal((3, 2048)).astype(np.float32)
    _close(GazeEstimator2.apply(tp, torch.from_numpy(feats)).numpy(),
           np.asarray(JG2.apply(g2_params, jnp.asarray(feats))), rtol=1e-5)
    want = np.asarray(jax.jit(lambda p, x: JG2.apply(p, x, extract_feature=True))(g2_params, jnp.asarray(images)))
    got = GazeEstimator2.apply(tp, torch.from_numpy(images), extract_feature=True).numpy()
    _close(got, want)
    t_init = GazeEstimator2.init(torch.Generator().manual_seed(0), extract_feature=True)
    assert t_init["head"]["fc0"]["w"].shape == (64, 2048) and t_init["resnet"]["layer4"][2]["conv3"]["w"].shape == (
        2048, 512, 1, 1)


def test_angular_distance_matches_jax():
    rng = np.random.default_rng(6)
    v1 = rng.standard_normal((7, 3)).astype(np.float32)
    v1 /= np.linalg.norm(v1, axis=1, keepdims=True)
    v2 = np.concatenate([v1[:2], -v1[2:3], rng.standard_normal((4, 3)).astype(np.float32)])
    v2 /= np.linalg.norm(v2, axis=1, keepdims=True)
    rad, deg = tmetrics.angular_distance(torch.from_numpy(v1), torch.from_numpy(v2))
    j_rad, j_deg = jmetrics.angular_distance(jnp.asarray(v1), jnp.asarray(v2))
    np.testing.assert_allclose(rad.numpy(), np.asarray(j_rad), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(deg.numpy(), np.asarray(j_deg), rtol=1e-5, atol=1e-4)
    assert np.isfinite(rad.numpy()).all()  # identical and opposite vectors clip, not NaN


def test_pad_height_and_strided_max_pool_match_jax():
    rng = np.random.default_rng(8)
    x = rng.random((2, 5, 7, 3)).astype(np.float32)
    np.testing.assert_array_equal(timg.pad_height(torch.from_numpy(x), 8, 8, 0.5).numpy(),
                                  np.asarray(jimg.pad_height(jnp.asarray(x), 8, 8, 0.5)))
    h = rng.standard_normal((2, 11, 14, 4)).astype(np.float32)
    hp = np.pad(h, ((0, 0), (1, 1), (1, 1), (0, 0)), constant_values=-np.inf)
    want = np.asarray(jl.max_pool(jnp.asarray(hp), 3, 2))
    got = tl.max_pool(torch.from_numpy(hp).permute(0, 3, 1, 2), 3, 2).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got, want)
