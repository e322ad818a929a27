"""The 2019 slice end to end on the CPU, against the same composition of
JAX functions, plus the port's packaging contracts.

Tolerances: the synthetic twin and the donor draw are exact; crops 1e-5;
VGG19 + classifier logits rtol 1e-4; the NST loss histories rtol 1e-3 and
the composited frames atol 2e-2 with a mean difference under 1e-4 (the
JAX package's own bound for diverging L-BFGS trajectories); RITnet labels
>= 99.5% agreement and the IoUs within 1e-2 (a pixel that flips class
moves an IoU by about 1/area).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from iris_style_transfer_tpu.data import synthetic as jsyn
from iris_style_transfer_tpu.data.openeds2019 import build_ist_dataset as j_build_ist_dataset
from iris_style_transfer_tpu.models import Classifier1 as JC1
from iris_style_transfer_tpu.models import Classifier2 as JC2
from iris_style_transfer_tpu.models import RITnet as JRITnet
from iris_style_transfer_tpu.models import VGG19 as JVGG
from iris_style_transfer_tpu.ops import metrics as jmetrics
from iris_style_transfer_tpu.ops.image import unpack_mask_bits as j_unpack_mask_bits
from iris_style_transfer_tpu.pipelines import iris as jiris
from iris_style_transfer_tpu.transfer.nst import make_nst_fn as j_make_nst_fn

from iris_style_transfer_tpu_torch.data import synthetic as tsyn
from iris_style_transfer_tpu_torch.data.openeds2019 import build_ist_dataset, sample_other
from iris_style_transfer_tpu_torch.models import Classifier1, Classifier2, RITnet, VGG19
from iris_style_transfer_tpu_torch.models.port import from_jax
from iris_style_transfer_tpu_torch.ops import metrics as tmetrics
from iris_style_transfer_tpu_torch.ops.image import unpack_mask_bits
from iris_style_transfer_tpu_torch.pipelines import iris as tiris
from iris_style_transfer_tpu_torch.transfer.nst import make_nst_fn
from iris_style_transfer_tpu_torch.utils import read_png

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W = 48, 64  # divisible through RITnet's four 2x2 pools and CLAHE's 8x8 grid


def test_synthetic_copy_matches_original():
    for a, b in zip(tsyn.synthetic_openeds2019(3, 3, seed=1, height=H, width=W),
                    jsyn.synthetic_openeds2019(3, 3, seed=1, height=H, width=W)):
        if isinstance(a, list):
            assert len(a) == len(b) and all(np.array_equal(x, y) for x, y in zip(a, b))
        else:
            assert a == b
    for a, b in zip(tsyn.synthetic_eye_batch(3, H, W, seed=2, gaze=True),
                    jsyn.synthetic_eye_batch(3, H, W, seed=2, gaze=True)):
        np.testing.assert_array_equal(a, b)


def test_ist_dataset_matches_jax():
    """Same seed, same donors; masks, bboxes, crops and pre-NST IoUs agree."""
    import random

    _, _, _, xs, ys, ms, _ = tsyn.synthetic_openeds2019(4, 4, seed=0, height=H, width=W)
    jp = JRITnet.pretrained()
    random.seed(5)
    want = j_build_ist_dataset(xs, ys, ms, jp, out_size=(32, 32), chunk=8, device_resident=False)
    random.seed(5)
    got = build_ist_dataset(xs, ys, ms, RITnet.pretrained(), out_size=(32, 32), chunk=3)
    np.testing.assert_array_equal(got.s_labels, want.s_labels)
    np.testing.assert_array_equal(got.c_labels, want.c_labels)
    np.testing.assert_array_equal(got.c_imgs.numpy(), want.c_imgs)
    np.testing.assert_array_equal(got.c_masks_gt.numpy(), want.c_masks_gt)
    m_t = unpack_mask_bits(got.c_masks_iris).numpy()
    m_j = np.asarray(j_unpack_mask_bits(jnp.asarray(want.c_masks_iris)))
    assert (m_t == m_j).mean() >= 0.995
    same_box = np.all(got.c_iris_bbs.numpy() == want.c_iris_bbs, axis=1)
    assert same_box.mean() >= 0.5
    crops_j = want.s_irises.astype(np.float32) / 65535.0
    random.seed(5)
    s_idx = [sample_other(lab, ys) for lab in ys]  # the draw both builders made
    donors_same = same_box[s_idx]  # rows whose donor crop has the same box
    np.testing.assert_allclose(got.s_irises.numpy()[donors_same], crops_j[donors_same], atol=1e-5)
    np.testing.assert_allclose(got.ious, want.ious, atol=1e-2)
    np.testing.assert_allclose(got.mious, want.mious, atol=1e-2)


@pytest.fixture(scope="module")
def slice_inputs():
    imgs, segs, _ = tsyn.synthetic_eye_batch(2, H, W, num_users=2, seed=4)
    imgs = (np.round(imgs * 255) / 255).astype(np.float32)
    rng = np.random.default_rng(0)

    def mlp(din):
        dims = (din, 32, 32, 4)
        return {f"fc{i}": {"w": (rng.standard_normal(dims[i : i + 2]) / np.sqrt(dims[i])).astype(np.float32),
                           "b": rng.standard_normal(dims[i + 1]).astype(np.float32)} for i in range(3)}

    vgg = jax.tree.map(np.asarray, jax.jit(JVGG.init)(jax.random.PRNGKey(0)))
    style = rng.random((2, 32, 32, 3)).astype(np.float32)
    return imgs, segs, style, vgg, mlp(512 * 49), mlp(1920)


def test_slice_matches_jax(slice_inputs):
    """crop -> VGG19 + both classifiers -> NST (3 closures) -> composite ->
    RITnet re-segmentation and IoU."""
    imgs, segs, style, vgg, c1, c2 = slice_inputs
    rit = JRITnet.pretrained()

    # JAX composition (jitted, as the JAX workload runs it)
    extract = jax.jit(lambda f, sg: jiris.extract_iris_batch(f, sg, out_size=(32, 32)))
    ir_j, m_j, bb_j = extract(jnp.asarray(imgs), jnp.asarray(segs))
    final_j, _, st_j = jax.jit(JVGG.apply)(vgg, ir_j)
    p1_j, p2_j = jax.jit(JC1.apply)(c1, final_j), jax.jit(JC2.apply)(c2, st_j)
    res_j = jax.jit(j_make_nst_fn(epochs=3))(vgg, ir_j, jnp.asarray(style))
    new_j = jax.jit(jiris.composite_batch)(jnp.asarray(imgs), res_j.x, m_j, bb_j)
    seg_j = jax.jit(JRITnet.apply)(rit, new_j)
    iou_j, _ = jmetrics.iou_per_class(seg_j, jnp.asarray(segs))

    # the port
    tv = from_jax(vgg)
    ir, m, bb = tiris.extract_iris_batch(torch.from_numpy(imgs), torch.from_numpy(segs), out_size=(32, 32))
    final, _, st = VGG19.apply(tv, ir.permute(0, 3, 1, 2))
    p1, p2 = Classifier1.apply(from_jax(c1), final), Classifier2.apply(from_jax(c2), st)
    res = make_nst_fn(epochs=3)(tv, ir.permute(0, 3, 1, 2), torch.from_numpy(style).permute(0, 3, 1, 2))
    new = tiris.composite_batch(torch.from_numpy(imgs), res.x.permute(0, 2, 3, 1), m, bb)
    seg = RITnet.apply(RITnet.pretrained(), new)
    iou, _ = tmetrics.iou_per_class(seg, torch.from_numpy(segs))

    np.testing.assert_array_equal(bb.numpy(), np.asarray(bb_j))
    np.testing.assert_allclose(ir.numpy(), np.asarray(ir_j), atol=1e-5)
    for a, b in ((p1, p1_j), (p2, p2_j)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=1e-4, atol=1e-4 * np.abs(b).max())
    np.testing.assert_allclose(res.s_loss_hist.numpy(), np.asarray(res_j.s_loss_hist), rtol=1e-3)
    np.testing.assert_allclose(res.c_loss_hist.numpy(), np.asarray(res_j.c_loss_hist), rtol=1e-3, atol=1e-10)
    assert np.mean(np.abs(new.numpy() - np.asarray(new_j))) < 1e-4
    np.testing.assert_allclose(new.numpy(), np.asarray(new_j), atol=2e-2)
    assert (seg.numpy() == np.asarray(seg_j)).mean() >= 0.995
    np.testing.assert_allclose(iou.numpy(), np.asarray(iou_j), atol=1e-2)


def test_mask_and_crop_iris_matches_jax():
    """RITnet (bundled weights) -> iris mask -> bbox crop -> RGB, against
    the JAX entry point on the same frames: bboxes exact, crops 1e-5.  At
    192 x 320 the bundled RITnet finds an iris in both frames."""
    imgs, _, _ = tsyn.synthetic_eye_batch(2, 192, 320, num_users=2, seed=6)
    imgs = (np.round(imgs * 255) / 255).astype(np.float32)
    ir_j, m_j, bb_j = jiris.mask_and_crop_iris(jnp.asarray(imgs), JRITnet.pretrained(), out_size=(32, 32))
    ir, m, bb = tiris.mask_and_crop_iris(torch.from_numpy(imgs), RITnet.pretrained(), out_size=(32, 32))
    assert ir.shape == (2, 32, 32, 3) and m.shape == (2, 192, 320, 1)
    assert (m.numpy() == np.asarray(m_j)).mean() >= 0.995
    np.testing.assert_array_equal(bb.numpy(), np.asarray(bb_j))
    np.testing.assert_allclose(ir.numpy(), np.asarray(ir_j), atol=1e-5)
    assert m.sum(dim=(1, 2, 3)).min() > 100
    # with area opening (area 500): the same agreement, bboxes exact
    ir_j, mo_j, bb_j = jiris.mask_and_crop_iris(jnp.asarray(imgs), JRITnet.pretrained(), out_size=(32, 32),
                                                use_area_opening=True)
    ir, mo, bb = tiris.mask_and_crop_iris(torch.from_numpy(imgs), RITnet.pretrained(), out_size=(32, 32),
                                          use_area_opening=True)
    assert (mo.numpy() == np.asarray(mo_j)).mean() >= 0.995
    np.testing.assert_array_equal(bb.numpy(), np.asarray(bb_j))
    assert not (mo & ~m).any() and mo.sum() > 100  # opening only removes


@pytest.mark.parametrize("connectivity", [1, 2])
def test_extract_iris_batch_area_opening_matches_jax(slice_inputs, connectivity):
    """``open_area`` removes the iris mask's small components before the
    crop: masks and bboxes exact, crops 1e-5.  A planted 4-pixel iris
    fragment, ringed by background, goes; the iris stays."""
    imgs, segs, _, _, _, _ = slice_inputs
    segs = segs.copy()
    segs[:, 0:5, 0:5] = 0  # background around ...
    segs[:, 1:3, 1:3] = 2  # ... a 4-pixel fragment in the corner
    imgs = imgs.copy()
    imgs[:, 1:3, 1:3] = 0.1  # below the glint threshold
    want = jiris.extract_iris_batch(jnp.asarray(imgs), jnp.asarray(segs), out_size=(32, 32), open_area=20,
                                    connectivity=connectivity)
    got = tiris.extract_iris_batch(torch.from_numpy(imgs), torch.from_numpy(segs), out_size=(32, 32),
                                   open_area=20, connectivity=connectivity)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-5)
    plain = tiris.extract_iris_batch(torch.from_numpy(imgs), torch.from_numpy(segs), out_size=(32, 32))
    assert plain[1][:, 1:3, 1:3].all() and not got[1][:, 1:3, 1:3].any()
    assert got[1].sum() > 0 and (got[1] == plain[1]).float().mean() > 0.99


def test_make_ist_fn_matches_jax(slice_inputs):
    """Extraction -> NST (2 closures) -> recomposition as one function."""
    imgs, segs, style, vgg, _, _ = slice_inputs
    s_ir = np.ascontiguousarray(style[:, :32, :32])
    want = jiris.make_ist_fn(j_make_nst_fn(epochs=2))(vgg, jnp.asarray(imgs), jnp.asarray(segs), jnp.asarray(s_ir))
    new, ir, res = tiris.make_ist_fn(make_nst_fn(epochs=2))(
        from_jax(vgg), torch.from_numpy(imgs), torch.from_numpy(segs), torch.from_numpy(s_ir))
    np.testing.assert_allclose(ir.numpy(), np.asarray(want[1]), atol=1e-5)
    np.testing.assert_allclose(res.s_loss_hist.numpy(), np.asarray(want[2].s_loss_hist), rtol=1e-3)
    assert np.mean(np.abs(new.numpy() - np.asarray(want[0]))) < 1e-4
    np.testing.assert_allclose(new.numpy(), np.asarray(want[0]), atol=2e-2)


def test_port_imports_no_jax():
    code = (
        "import sys\n"
        "import iris_style_transfer_tpu_torch\n"
        "from iris_style_transfer_tpu_torch import data, models, ops, parallel, pipelines, runtime, transfer, utils\n"
        "from iris_style_transfer_tpu_torch.parallel import mesh\n"
        "from iris_style_transfer_tpu_torch.workloads import ist_openeds2019, ist_openeds2020\n"
        "from iris_style_transfer_tpu_torch.workloads import gaze_estimation, iris_classification\n"
        "from iris_style_transfer_tpu_torch.demos import iris_nst_demo, nst_demo\n"
        "from iris_style_transfer_tpu_torch.data import fake_openeds, native_loader, openeds2020\n"
        "from iris_style_transfer_tpu_torch.tools import replicate_rotation, replicate_synthetic\n"
        "from iris_style_transfer_tpu_torch.tools import port_weights, replicate_synthetic_gaze\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'iris_style_transfer_tpu.'))]\n"
        "assert not bad and 'iris_style_transfer_tpu' not in sys.modules, bad\n"
        "assert not [m for m in sys.modules if m == 'tools' or m.startswith('tools.')]\n"
        "imaging = [m for m in sys.modules if m.split('.')[0] in ('PIL', 'cv2', 'pandas')]\n"
        "assert not imaging, imaging\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)


def test_main_refuses_what_it_cannot_run(tmp_path, monkeypatch):
    from iris_style_transfer_tpu_torch.workloads import ist_openeds2019 as wl

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA is not available"):
        wl.main(["--device", "cuda"])
    with pytest.raises(SystemExit, match="ROADMAP"):
        wl.main(["--device", "cpu", "--model_parallel", "2"])
    # an existing data directory is read: one without the tree's files
    # fails as the JAX main's does, on the first mapping file
    (tmp_path / "data" / "openeds2019").mkdir(parents=True)
    with pytest.raises(FileNotFoundError, match="OpenEDS_train_userID_mapping_to_images.json"):
        wl.main(["--device", "cpu", "--data_dir", str(tmp_path / "data")])


def test_main_runs_from_a_data_tree(tmp_path, monkeypatch):
    """The 2019 main reads a fake OpenEDS2019 tree (frames and labels) and
    evaluates its test split: every test frame of the loader, in order."""
    from iris_style_transfer_tpu_torch.data import fake_openeds, load_data_openeds2019
    from iris_style_transfer_tpu_torch.utils import seed as seed_all
    from iris_style_transfer_tpu_torch.workloads import ist_openeds2019 as wl

    fake_openeds.write_openeds2019(str(tmp_path / "data"), users=(2, 1, 1), frames_per_user=8, height=H, width=W)
    monkeypatch.chdir(tmp_path)
    seed_all(7, verbose=False)
    _, _, _, test_x, _, test_m, num_class = load_data_openeds2019(load_seg=True, data_dir=str(tmp_path / "data"
                                                                                            / "openeds2019"))
    results = wl.main(["-bs", "2", "--nst_epochs", "1", "-seed", "7", "--data_dir", str(tmp_path / "data"),
                       "--device", "cpu", "--compute_dtype", "float32"])
    log = results[("test/", 1.0, 1)]
    for key in ("test/pre/c1/accu", "test/post/c2/mis/f1", "test/post/mean_miou", "test//s_loss"):
        assert key in log and np.isfinite(log[key]), key
    out = tmp_path / "saved" / "openeds2019" / "sw_1.0_epoch_1" / "test"
    assert len(np.load(out / "mious_pre.npy")) == len(np.load(out / "mious_post.npy")) == len(test_x) > 0
    np.testing.assert_array_equal(read_png(str(out / "batch_0_raw.png"))[..., 0], test_x[0][..., 0])
    assert num_class == 4


@pytest.mark.slow
def test_main_runs_on_cpu(tmp_path, monkeypatch):
    """The port's main end to end on the synthetic twin (small frames)."""
    _run_main(tmp_path, monkeypatch, [])


@pytest.mark.slow
def test_main_runs_with_stats_taps_on_cpu(tmp_path, monkeypatch):
    _run_main(tmp_path, monkeypatch, ["--stats_taps", "on"])


def _run_main(tmp_path, monkeypatch, extra):
    from iris_style_transfer_tpu_torch.workloads import ist_openeds2019 as wl

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(wl, "synthetic_openeds2019", lambda n_per_user=6, num_users=8, seed=0:
                        tsyn.synthetic_openeds2019(n_per_user, 3, seed=seed, height=H, width=W))
    argv = ["-bs", "8", "--nst_epochs", "2", "--data_dir", str(tmp_path / "nodata"), "--device", "cpu", *extra]
    results = wl.main(argv)
    log = results[("test/", 1.0, 2)]
    for key in ("test/pre/c1/accu", "test/pre/c2/mis/f1", "test/post/c1/loss", "test/post/c2/mis/auc",
                "test/post/mean_miou", "test/post/mean_iou2", "test//c_loss", "test//s_loss",
                "test/stylized_images_per_min", "test/pipeline_images_per_min"):
        assert key in log and np.isfinite(log[key]), key
    out = tmp_path / "saved" / "openeds2019" / "sw_1.0_epoch_2" / "test"
    for name in ("mious_post.npy", "ious2_pre.npy", "done.json", "batch_0_new.png"):
        assert (out / name).exists(), name
    assert wl.main(argv) == {}  # the completed combo is skipped
