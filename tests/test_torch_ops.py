"""CPU parity of the torch port's ops against the JAX package.

The same numpy inputs, made from a seed, go through the JAX function and
its port.  Tolerances: the relu+pool pair, the bit codecs, bbox, gamma,
CLAHE and IoU are exact; losses rtol 1e-6; resampling and metrics 1e-5
(float32 sums taken in another order).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from iris_style_transfer_tpu.models import layers as jl
from iris_style_transfer_tpu.ops.clahe import clahe as j_clahe
from iris_style_transfer_tpu.ops import gram as jgram
from iris_style_transfer_tpu.ops import image as jimg
from iris_style_transfer_tpu.ops import losses as jlosses
from iris_style_transfer_tpu.ops import metrics as jmetrics
from iris_style_transfer_tpu.ops import pallas_pool_paired as pp
from iris_style_transfer_tpu.pipelines import iris as jiris

from iris_style_transfer_tpu_torch.models import layers as tl
from iris_style_transfer_tpu_torch.ops.clahe import clahe as t_clahe
from iris_style_transfer_tpu_torch.ops import gram as tgram
from iris_style_transfer_tpu_torch.ops import image as timg
from iris_style_transfer_tpu_torch.ops import losses as tlosses
from iris_style_transfer_tpu_torch.ops import metrics as tmetrics
from iris_style_transfer_tpu_torch.ops import relu_pool as rp
from iris_style_transfer_tpu_torch.pipelines import iris as tiris


def _nchw(a: np.ndarray) -> torch.Tensor:
    """NHWC numpy -> NCHW tensor with channels_last memory (a view)."""
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).float().numpy()


def _tied_input(shape, seed, dtype):
    """NHWC values exactly representable in ``dtype``, with planted exact
    window ties, zero windows and all-negative windows."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 2).astype(np.float32)
    x[1, 2, 2, 0] = x[1, 2, 3, 0]  # two maxima in one window
    x[0, 4:6, 4:6, :] = np.abs(x[0, 4, 4, :])  # four equal positive maxima
    x[0, 0:2, 0:2, :] = 0.0  # all-zero window
    x[2, 6:8, 2:4, :] = -np.abs(x[2, 6:8, 2:4, :]) - 0.5  # all-negative window
    return torch.from_numpy(x).to(dtype).float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_relu_pool_plain_matches_pallas_4d_and_vjp(dtype):
    """The plain relu+pool (the CPU side of the Hopper kernel) equals the
    JAX 4-D Pallas pair in interpret mode and the relu_max_pool VJP, bit
    for bit, ties included."""
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    x = _tied_input((8, 16, 16, 16), 13, tdt)
    ct = torch.from_numpy(np.random.default_rng(14).standard_normal((8, 8, 8, 16)).astype(np.float32))
    ct = ct.to(tdt).float().numpy()
    xj, ctj = jnp.asarray(x).astype(jdt), jnp.asarray(ct).astype(jdt)

    y_kernel = pp.relu_pool_fwd_4d(xj, interpret=True)
    y_vjp, pull = jax.vjp(lambda v: jl.relu_max_pool(v, 2), xj)
    g_vjp = pull(ctj)[0]
    g_kernel = pp.relu_pool_bwd_4d(xj, y_kernel, ctj, interpret=True)

    xt, ctt = _nchw(x).to(tdt), _nchw(ct).to(tdt)
    y = rp.relu_pool_fwd(xt)
    g = rp.relu_pool_bwd(xt, y, ctt)
    assert y.dtype == tdt and g.dtype == tdt
    assert y.is_contiguous(memory_format=torch.channels_last)
    for want in (y_kernel, y_vjp):
        np.testing.assert_array_equal(_nhwc(y), np.asarray(want.astype(jnp.float32)))
    for want in (g_kernel, g_vjp):
        np.testing.assert_array_equal(_nhwc(g), np.asarray(want.astype(jnp.float32)))
    # the planted 4-way tie hands the full cotangent to every element
    assert np.all(_nhwc(g)[0, 4:6, 4:6, 0] == ct[0, 2, 2, 0])


def test_relu_pool_autograd_function_matches_composed_torch():
    """ReluMaxPool2's gradient equals autograd through relu + the
    tie-to-all max_pool; the Function saves (x, y)."""
    x = _nchw(_tied_input((4, 8, 8, 3), 3, torch.float32)).requires_grad_(True)
    ct = torch.randn(4, 3, 4, 4, generator=torch.Generator().manual_seed(0))
    (g1,) = torch.autograd.grad(rp.relu_max_pool(x), x, ct)
    (g2,) = torch.autograd.grad(tl.max_pool(torch.relu(x), 2), x, ct)
    assert torch.equal(g1, g2)


def test_relu_pool_rejects_odd_extents_and_other_devices():
    with pytest.raises(ValueError, match="even"):
        rp.relu_pool_fwd(torch.zeros(1, 4, 6, 7))
    with pytest.raises(ValueError, match="device"):
        rp.relu_pool_fwd(torch.zeros(1, 4, 6, 6, device="meta"))


@pytest.mark.parametrize("shape", [(2, 9, 7, 3), (1, 6, 5, 2)])
def test_max_pool_odd_extents_match_reduce_window(shape):
    """Odd extents take the plain pool: forward and gradient equal the
    JAX reduce_window max-pool (one winner per window)."""
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    y_j, pull = jax.vjp(lambda v: jl.max_pool(v, 2, 2), jnp.asarray(x))
    ct = np.random.default_rng(2).standard_normal(y_j.shape).astype(np.float32)
    xt = _nchw(x).requires_grad_(True)
    y = tl.max_pool(xt, 2)
    (g,) = torch.autograd.grad(y, xt, _nchw(ct))
    np.testing.assert_array_equal(_nhwc(y.detach()), np.asarray(y_j))
    np.testing.assert_array_equal(_nhwc(g), np.asarray(pull(jnp.asarray(ct))[0]))


def test_max_pool_even_extents_tie_to_all_matches_jax():
    x = _tied_input((4, 8, 8, 5), 9, torch.float32)
    y_j, pull = jax.vjp(lambda v: jl.max_pool(v, 2, 2), jnp.asarray(x))
    ct = np.random.default_rng(3).standard_normal(y_j.shape).astype(np.float32)
    xt = _nchw(x).requires_grad_(True)
    y = tl.max_pool(xt, 2)
    (g,) = torch.autograd.grad(y, xt, _nchw(ct))
    np.testing.assert_array_equal(_nhwc(y.detach()), np.asarray(y_j))
    np.testing.assert_array_equal(_nhwc(g), np.asarray(pull(jnp.asarray(ct))[0]))


# ---------------------------------------------------------------------------
# losses and Gram
# ---------------------------------------------------------------------------


def _feats(seed, shapes=((2, 8, 8, 4), (2, 4, 4, 6))):
    rng = np.random.default_rng(seed)
    return [np.maximum(rng.standard_normal(s), 0).astype(np.float32) for s in shapes]


def test_losses_and_gram_match_jax():
    preds, targets = _feats(0), _feats(1)
    jp, jt = [jnp.asarray(a) for a in preds], [jnp.asarray(a) for a in targets]
    tp, tt = [_nchw(a) for a in preds], [_nchw(a) for a in targets]
    rt = dict(rtol=1e-6, atol=0)

    np.testing.assert_allclose(
        float(tlosses.content_loss_l2(tp, tt, [1.0, 0.5])),
        float(jlosses.content_loss_l2(jp, jt, [1.0, 0.5])), **rt)
    for a, b in zip(tp, jp):
        tm, ts = tlosses.style_stats(a)
        jm, js = jlosses.style_stats(b)
        np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(tgram.gram_matrix(a).numpy(), np.asarray(jgram.gram_matrix(b)),
                                   rtol=1e-6, atol=1e-7)
    t_stats = [tlosses.style_stats(a) for a in tt]
    j_stats = [jlosses.style_stats(b) for b in jt]
    np.testing.assert_allclose(float(tlosses.style_loss_bn(tp, t_stats)),
                               float(jlosses.style_loss_bn(jp, j_stats)), **rt)
    t_grams = [tgram.gram_matrix(a) for a in tt]
    j_grams = [jgram.gram_matrix(b) for b in jt]
    np.testing.assert_allclose(float(tlosses.style_loss_gram(tp, t_grams)),
                               float(jlosses.style_loss_gram(jp, j_grams)), **rt)
    s1, s2 = np.float32([3.0, 5.0]), np.float32([9.0, 30.0])
    for a, b in zip(tlosses.stats_from_sums(torch.from_numpy(s1), torch.from_numpy(s2), 4),
                    jlosses.stats_from_sums(jnp.asarray(s1), jnp.asarray(s2), 4)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)


# ---------------------------------------------------------------------------
# image ops, CLAHE, pipelines
# ---------------------------------------------------------------------------


def test_codecs_and_quantizers_match_jax():
    rng = np.random.default_rng(5)
    m = rng.random((3, 6, 16, 1)) > 0.5
    packed = timg.pack_mask_bits(torch.from_numpy(m))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jimg.pack_mask_bits(jnp.asarray(m))))
    np.testing.assert_array_equal(timg.unpack_mask_bits(packed).numpy(), m)
    assert torch.equal(timg.as_bool_mask(packed), torch.from_numpy(m))

    seg = rng.integers(0, 4, (2, 5, 12)).astype(np.uint8)
    lab = timg.pack_labels2(seg)
    np.testing.assert_array_equal(lab, jimg.pack_labels2(seg))
    np.testing.assert_array_equal(timg.as_label_map(torch.from_numpy(lab), 12).numpy(), seg)
    np.testing.assert_array_equal(
        timg.unpack_labels2(torch.from_numpy(lab)).numpy(), np.asarray(jimg.unpack_labels2(jnp.asarray(lab))))

    x = rng.random((4, 7, 1)).astype(np.float32)
    q = timg.quantize_u16(torch.from_numpy(x))
    assert q.dtype == torch.uint16
    np.testing.assert_array_equal(q.numpy(), np.asarray(jimg.quantize_u16(jnp.asarray(x))))
    np.testing.assert_array_equal(timg.to_unit_float(q).numpy(), np.asarray(jimg.to_unit_float(jimg.quantize_u16(jnp.asarray(x)))))
    u8 = timg.quantize_u8(x)
    np.testing.assert_array_equal(u8, jimg.quantize_u8(x))
    np.testing.assert_array_equal(timg.to_unit_float(torch.from_numpy(u8)).numpy(),
                                  np.asarray(jimg.to_unit_float(jnp.asarray(u8))))


def test_gamma_normalize_and_color_match_jax():
    levels = np.arange(256, dtype=np.float32) / 255.0
    np.testing.assert_array_equal(timg.gamma_lut(torch.from_numpy(levels)).numpy(),
                                  np.asarray(jimg.gamma_lut(jnp.asarray(levels))))
    rng = np.random.default_rng(6)
    rgb = rng.random((2, 5, 4, 3)).astype(np.float32)
    np.testing.assert_allclose(_nhwc(timg.imagenet_normalize(_nchw(rgb))),
                               np.asarray(jimg.imagenet_normalize(jnp.asarray(rgb))), rtol=1e-6)
    np.testing.assert_allclose(timg.rgb_to_grayscale(torch.from_numpy(rgb)).numpy(),
                               np.asarray(jimg.rgb_to_grayscale(jnp.asarray(rgb))), rtol=1e-6)
    gray = rgb[..., :1]
    np.testing.assert_array_equal(timg.gray_to_rgb(torch.from_numpy(gray)).numpy(),
                                  np.asarray(jimg.gray_to_rgb(jnp.asarray(gray))))


def test_clahe_matches_jax_and_cv2():
    """Exact against the JAX CLAHE on a small batch (one tile set clipped
    and redistributed); against OpenCV at the workloads' 400x640 with the
    JAX package's own contract (cv2 interpolates in fixed point: at most
    one level off, on under 1% of pixels)."""
    rng = np.random.default_rng(7)
    u8 = rng.integers(0, 256, size=(2, 64, 96), dtype=np.uint8)
    u8[1, :20] = rng.integers(100, 110, size=(20, 96))
    x = u8.astype(np.float32) / 255.0
    got = t_clahe(torch.from_numpy(x)).numpy()
    want = np.stack([np.asarray(j_clahe(jnp.asarray(im))) for im in x])
    np.testing.assert_array_equal(got, want)

    cv2 = pytest.importorskip("cv2")
    frame = rng.integers(0, 256, size=(400, 640), dtype=np.uint8)
    frame[:100] = rng.integers(60, 70, size=(100, 640))
    out = t_clahe(torch.from_numpy(frame.astype(np.float32)[None] / 255.0))[0].numpy()
    ref = cv2.createCLAHE(clipLimit=1.5, tileGridSize=(8, 8)).apply(frame)
    diff = np.abs(np.round(out * 255).astype(np.int32) - ref.astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() < 0.01


def _frames_and_segs(seed, b=3, h=40, w=48):
    from iris_style_transfer_tpu_torch.data.synthetic import synthetic_eye_batch

    imgs, segs, _ = synthetic_eye_batch(b, h, w, num_users=2, seed=seed)
    return imgs, segs


def test_extract_crop_and_composite_match_jax():
    imgs, segs = _frames_and_segs(0)
    segs[2] = 0  # an empty mask: the bbox falls back to the full frame
    extract = jax.jit(lambda f, sg: jiris.extract_iris_batch(f, sg, out_size=(24, 20)))
    j_irises, j_masks, j_bbs = extract(jnp.asarray(imgs), jnp.asarray(segs))
    irises, masks, bbs = tiris.extract_iris_batch(torch.from_numpy(imgs), torch.from_numpy(segs), out_size=(24, 20))
    np.testing.assert_array_equal(masks.numpy(), np.asarray(j_masks))
    np.testing.assert_array_equal(bbs.numpy(), np.asarray(j_bbs))
    np.testing.assert_allclose(irises.numpy(), np.asarray(j_irises), atol=1e-5)
    assert tuple(bbs[2].tolist()) == (0, 0, 39, 47)

    stylized = np.random.default_rng(8).random((3, 24, 20, 3)).astype(np.float32)
    want = jax.jit(jiris.composite_batch)(jnp.asarray(imgs), jnp.asarray(stylized), j_masks, j_bbs)
    got = tiris.composite_batch(torch.from_numpy(imgs), torch.from_numpy(stylized), masks, bbs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    pasted, inside = timg.paste_resized((40, 48), torch.from_numpy(stylized), bbs)
    j_pasted, j_inside = jax.jit(jimg.paste_resized, static_argnums=0)((40, 48), jnp.asarray(stylized[0]), j_bbs[0])
    np.testing.assert_allclose(pasted[0].numpy(), np.asarray(j_pasted), atol=1e-5)
    np.testing.assert_array_equal(inside[0].numpy(), np.asarray(j_inside))


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("present_only", [False, True])
def test_classification_metrics_match_jax(present_only):
    rng = np.random.default_rng(9)
    labels = rng.integers(0, 6, 40).astype(np.int32)
    logits = rng.standard_normal((40, 8)).astype(np.float32)
    logits[3] = logits[4]  # tied scores across samples
    want = jmetrics.classification_metrics(jnp.asarray(labels), jnp.asarray(logits), 8,
                                           auc_present_only=present_only)
    got = tmetrics.classification_metrics(torch.from_numpy(labels), torch.from_numpy(logits), 8,
                                          auc_present_only=present_only)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, atol=1e-6, err_msg=k)


def test_iou_per_class_matches_jax():
    rng = np.random.default_rng(10)
    p = rng.integers(0, 4, (3, 10, 12))
    t = rng.integers(0, 4, (3, 10, 12))
    t[1] = 0  # absent classes
    ious, miou = tmetrics.iou_per_class(torch.from_numpy(p), torch.from_numpy(t))
    j_ious, j_miou = jmetrics.iou_per_class(jnp.asarray(p), jnp.asarray(t))
    np.testing.assert_allclose(ious.numpy(), np.asarray(j_ious), rtol=1e-6)
    np.testing.assert_allclose(miou.numpy(), np.asarray(j_miou), rtol=1e-6)
