"""The port's OpenEDS loaders against the JAX package's, on fake trees that
the port writes from the synthetic twin in the datasets' layouts
(``data/fake_openeds.py``: row filters 0-4 and adaptive; 17-digit labels).

Frames, labels, splits, class counts, stream batches and ``valid`` masks
are compared exactly.  The JAX loaders decode through their libpng library
where it builds, else PIL; both give the port's values on gray files
(``tests/test_torch_decode.py``).  Features (``extract_feature=True``):
ResNet50's 2048 features rtol 1e-3 of their scale (50 float32 conv layers
summed in another order); the 19 landmarks from B7's labels atol 1e-3 of
the pixel scale max(H, W) where every label agrees, as in
``tests/test_torch_gaze.py``.
"""

import random

import numpy as np
import pytest
import torch

import jax

from iris_style_transfer_tpu.data import openeds2019 as j19
from iris_style_transfer_tpu.data import openeds2020 as j20
from iris_style_transfer_tpu.models import EfficientNet as JEff
from iris_style_transfer_tpu.models import ResNet50 as JResNet50

from iris_style_transfer_tpu_torch.data import fake_openeds, openeds2019 as t19, openeds2020 as t20
from iris_style_transfer_tpu_torch.models import EfficientNet
from iris_style_transfer_tpu_torch.models.port import from_jax


@pytest.fixture(scope="module")
def tree19(tmp_path_factory):
    return fake_openeds.write_openeds2019(str(tmp_path_factory.mktemp("d19")), users=(4, 3, 3),
                                          frames_per_user=5, height=24, width=32, seed=3)


@pytest.fixture(scope="module")
def tree20(tmp_path_factory):
    return fake_openeds.write_openeds2020(str(tmp_path_factory.mktemp("d20")), sequences=(5, 2, 2),
                                          frames_per_sequence=26, height=16, width=24, seed=5)


def _load19(mod, tree, seed, load_seg):
    random.seed(seed)
    out = mod.load_data_openeds2019(0.2, load_seg=load_seg, data_dir=tree)
    labels = out[1] + out[4]
    donors = [mod.sample_other(l, labels) for l in labels]
    return out, donors


@pytest.mark.parametrize("seed", [0, 42])
@pytest.mark.parametrize("load_seg", [True, False])
def test_load_openeds2019_equals_jax(tree19, seed, load_seg):
    (got, donors), (want, donors_j) = _load19(t19, tree19, seed, load_seg), _load19(j19, tree19, seed, load_seg)
    assert got[6] == want[6] and got[6] > 0  # class_count
    assert len(got[0]) > 0 and len(got[3]) > 0
    for g, w in zip(got[:6], want[:6]):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            if b is None:
                assert a is None
            else:
                assert type(a) is type(b) and np.asarray(a).dtype == np.asarray(b).dtype
                np.testing.assert_array_equal(a, b, strict=True)
    assert got[0][0].shape == (24, 32, 1) and got[0][0].dtype == np.uint8
    assert donors == donors_j  # the same host random stream after the split
    assert t19.MAPPING_KEY == j19.MAPPING_KEY


def test_split_sizes_equal_jax():
    for n in range(3, 30):
        for r in (0.1, 0.2, 0.25, 0.5):
            assert t19._test_split_size(n, r) == j19._test_split_size(n, r)


def test_missing_tree_fails_as_jax(tmp_path):
    for mod in (t19, j19):
        with pytest.raises(FileNotFoundError):
            mod.load_data_openeds2019(data_dir=str(tmp_path))
    for mod in (t20, j20):
        with pytest.raises(FileNotFoundError):
            mod.load_labels_openeds2020(str(tmp_path), "validation/")


@pytest.mark.parametrize("split", ["train/", "validation/", "test/"])
def test_labels_and_frames_equal_jax(tree20, split):
    labels = t20.load_labels_openeds2020(tree20, split)
    np.testing.assert_array_equal(labels, j20.load_labels_openeds2020(tree20, split))
    assert labels.dtype == np.float32 and labels.shape[1] == 3
    imgs, labs = t20.load_data_openeds2020(False, data_path=tree20, postfix=split)
    imgs_j, labs_j = j20.load_data_openeds2020(False, data_path=tree20, postfix=split)
    assert imgs.dtype == np.uint8 and imgs.shape == imgs_j.shape == (len(labels), 16, 24, 1)
    np.testing.assert_array_equal(imgs, imgs_j)
    np.testing.assert_array_equal(labs, labs_j)
    np.testing.assert_array_equal(labs, labels)


def test_labels_are_correctly_rounded(tree20):
    """Each label is the float32 cast of the correctly rounded float64 of
    its 17-digit text."""
    seq_paths, labels = t20._sequence_index(tree20, "test/")
    name = seq_paths[0][0].split("/")[-2]
    rows = open(f"{tree20}test/labels/{name}.txt").read().split()
    want = np.array([[float(v) for v in r.split(",")[1:]] for r in rows], np.float64).astype(np.float32)
    assert len(rows) == len(labels[0]) + 5  # the test split's extra rows are dropped
    np.testing.assert_array_equal(labels[0], want[: len(labels[0])])


@pytest.mark.parametrize("drop_remainder", [False, True])
@pytest.mark.parametrize("shuffle_seed", [None, 7])
def test_stream_equals_jax(tree20, shuffle_seed, drop_remainder):
    kw = dict(batch_size=12, shuffle_seed=shuffle_seed, drop_remainder=drop_remainder, buffer_batches=2)
    stats, stats_j = {}, {}
    got = list(t20.stream_openeds2020(tree20, "train/", stats=stats, **kw))
    want = list(j20.stream_openeds2020(tree20, "train/", stats=stats_j, **kw))
    assert len(got) == len(want) == (130 // 12 if drop_remainder else -(-130 // 12))
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    assert stats == stats_j and 0 < stats["peak_buffer_frames"] <= 2 * 12 + 26 + 12
    frames = np.concatenate([b[0][b[2]] for b in got])
    if shuffle_seed is None and not drop_remainder:  # FIFO: the eager loader's order
        np.testing.assert_array_equal(frames, t20.load_data_openeds2020(False, data_path=tree20,
                                                                        postfix="train/")[0])


def test_background_yields_in_order_and_reraises():
    from iris_style_transfer_tpu_torch.data import background

    assert list(background(iter(range(50)), size=3)) == list(range(50))

    def broken():
        yield 1
        raise KeyError("producer")

    with pytest.raises(KeyError, match="producer"):
        list(background(broken()))


def _fill(shapes, rng, scale):
    def leaf(path, s):
        name = getattr(path[-1], "key", "")
        if name == "w":
            return (rng.standard_normal(s.shape) * scale(s.shape)).astype(np.float32)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        return (rng.standard_normal(s.shape) * 0.1).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@pytest.fixture(scope="module")
def tree20_features(tmp_path_factory):
    """One validation sequence of 2 frames at 48 x 64 (B7 pads to 64 x 64):
    one chunk of 2, so each JAX program compiles once."""
    return fake_openeds.write_openeds2020(str(tmp_path_factory.mktemp("f20")), sequences=(0, 1, 0),
                                          frames_per_sequence=2, height=48, width=64, seed=9)


def test_resnet_features_equal_jax(tree20_features):
    shapes = jax.eval_shape(JResNet50.init, jax.random.PRNGKey(0))
    jp = _fill(shapes, np.random.default_rng(1), lambda s: np.sqrt(2.0 / np.prod(s[:-1])))
    want, labs_j = j20.load_data_openeds2020(True, 2, tree20_features, "validation/", resnet_params=jp, chunk=2)
    got, labs = t20.load_data_openeds2020(True, 2, tree20_features, "validation/", resnet_params=from_jax(jp),
                                          chunk=2)
    assert got.shape == want.shape == (2, 2048) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-3 * np.abs(want).max())
    np.testing.assert_array_equal(labs, labs_j)


def test_landmark_features_equal_jax(tree20_features):
    """B7 (seeded at fan-in scale, the head's bias centring each class's
    mean logit so that the labels hold every class) then the landmarks."""
    shapes = jax.eval_shape(JEff.init, jax.random.PRNGKey(0))
    jp = _fill(shapes, np.random.default_rng(0), lambda s: 1 / np.sqrt(np.prod(s[:-1])))
    tp = from_jax(jp)
    frames, _ = t20.load_data_openeds2020(False, data_path=tree20_features, postfix="validation/")
    x = torch.nn.functional.pad(torch.from_numpy(frames).float().div(255).repeat_interleave(3, dim=-1),
                                (0, 0, 0, 0, 8, 8)).permute(0, 3, 1, 2)
    from iris_style_transfer_tpu_torch.ops.image import imagenet_normalize

    with torch.no_grad():
        shift = EfficientNet.logits(tp, imagenet_normalize(x)).mean(dim=(0, 2, 3)).numpy()
    jp["head"]["b"] = jp["head"]["b"] - shift
    tp = from_jax(jp)
    want, labs_j = j20.load_data_openeds2020(True, 1, tree20_features, "validation/", efficientnet_params=jp,
                                             chunk=2)
    got, labs = t20.load_data_openeds2020(True, 1, tree20_features, "validation/", efficientnet_params=tp,
                                          chunk=2)
    segs = EfficientNet.apply(tp, torch.from_numpy(frames).float() / 255)
    assert len(torch.unique(segs)) == 4  # every class, so that every landmark is computed
    assert got.shape == want.shape == (2, 19)
    np.testing.assert_allclose(got, want, atol=1e-3 * 64)
    np.testing.assert_array_equal(labs, labs_j)


def test_fake_tree_cli_writes_both_layouts(tmp_path):
    """``python -m ...data.fake_openeds --out DIR`` writes both trees in the
    layouts the loaders read, every row filter among the frames."""
    fake_openeds.main(["--out", str(tmp_path), "--height", "16", "--width", "24"])
    out = t19.load_data_openeds2019(load_seg=True, data_dir=str(tmp_path / "openeds2019"))
    assert out[6] > 0 and out[0][0].shape == (16, 24, 1) and out[1][0] >= 0
    gaze = str(tmp_path / fake_openeds.GAZE_DIR) + "/"
    for split in ("train/", "validation/", "test/"):
        frames, labels = t20.load_data_openeds2020(False, data_path=gaze, postfix=split)
        assert len(frames) == len(labels) > 0
        np.testing.assert_allclose(np.linalg.norm(labels, axis=1), 1.0, rtol=1e-6)
    assert (tmp_path / fake_openeds.GAZE_DIR / "test" / "sequences" / "2577" / "023.png").exists()
