"""CPU parity of the torch port's models against the JAX package.

JAX parameters come from the JAX package's own ``init``s and reach the
port through ``models.port.from_jax``.  Tolerances: layers 1e-5; VGG19
taps in float32 rtol 1e-4 / atol 1e-5 (float32 convs summed in another
order), the input gradient rtol 1e-3 / atol 1e-5 of its largest element;
VGG19 in bfloat16 within 5% of each tap's scale (bf16 keeps 8 bits and the
two frameworks round at different points of the conv + bias); RITnet with
the bundled weights >= 99.5% argmax agreement; the classifier heads 1e-5.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from iris_style_transfer_tpu.models import Classifier1 as JC1
from iris_style_transfer_tpu.models import Classifier2 as JC2
from iris_style_transfer_tpu.models import RITnet as JRITnet
from iris_style_transfer_tpu.models import VGG19 as JVGG
from iris_style_transfer_tpu.models import layers as jl
from iris_style_transfer_tpu.models.port import save_npz
from iris_style_transfer_tpu.ops import losses as jlosses

from iris_style_transfer_tpu_torch.data.synthetic import synthetic_eye_batch
from iris_style_transfer_tpu_torch.models import Classifier1, Classifier2, RITnet, VGG19
from iris_style_transfer_tpu_torch.models import layers as tl
from iris_style_transfer_tpu_torch.models.port import from_jax, load_npz
from iris_style_transfer_tpu_torch.ops import losses as tlosses


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).float().numpy()


@pytest.fixture(scope="module")
def vgg_params():
    jp = _np_tree(jax.jit(JVGG.init)(jax.random.PRNGKey(0)))
    return jp, from_jax(jp)


def test_weight_bridge_layouts_and_npz_reader(tmp_path, vgg_params):
    jp, tp = vgg_params
    assert tp["conv1_1"]["w"].shape == (64, 3, 3, 3)
    np.testing.assert_array_equal(tp["conv2_1"]["w"].numpy(), np.transpose(jp["conv2_1"]["w"], (3, 2, 0, 1)))
    lin = {"fc0": {"w": np.arange(6, dtype=np.float32).reshape(2, 3), "b": np.zeros(3, np.float32)}}
    np.testing.assert_array_equal(from_jax(lin)["fc0"]["w"].numpy(), lin["fc0"]["w"].T)
    bn = {"bn": {k: np.full(4, i, np.float32) for i, k in enumerate(("scale", "bias", "mean", "var"))}}
    assert {k: float(v[0]) for k, v in from_jax(bn)["bn"].items()} == {"scale": 0, "bias": 1, "mean": 2, "var": 3}
    # the JAX package's flattened npz format, lists included
    path = os.path.join(tmp_path, "p.npz")
    save_npz(path, {"vgg": {"conv1_1": jp["conv1_1"]}, "stages": [{"w": np.ones((2, 2), np.float32)}]})
    back = load_npz(path)
    np.testing.assert_array_equal(back["vgg"]["conv1_1"]["w"], jp["conv1_1"]["w"])
    assert isinstance(back["stages"], list) and back["stages"][0]["w"].shape == (2, 2)


def test_restore_params_reads_jax_checkpoints(tmp_path):
    from iris_style_transfer_tpu.runtime.checkpoint import save_checkpoint
    from iris_style_transfer_tpu_torch.runtime.checkpoint import restore_params

    head = {"fc0": {"w": np.arange(6, dtype=np.float32).reshape(3, 2), "b": np.ones(2, np.float32)}}
    save_checkpoint(str(tmp_path), 3, {"params": head})
    save_checkpoint(str(tmp_path), 7, {"params": jax.tree.map(lambda a: a + 1, head)})
    assert restore_params("", default="fallback") == "fallback"
    got = restore_params(str(tmp_path / "step_00000003.npz"))
    np.testing.assert_array_equal(got["fc0"]["w"].numpy(), head["fc0"]["w"].T)
    latest = restore_params(str(tmp_path))  # a directory loads its latest step
    np.testing.assert_array_equal(latest["fc0"]["b"].numpy(), head["fc0"]["b"] + 1)
    with pytest.raises(FileNotFoundError):
        restore_params(str(tmp_path / "missing"))


def test_layers_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 8, 12, 5)).astype(np.float32)
    conv = _np_tree(jl.init_conv(jax.random.PRNGKey(1), 3, 3, 5, 7))
    lin = _np_tree(jl.init_linear(jax.random.PRNGKey(2), 5, 4))
    bn = {"scale": rng.random(5).astype(np.float32) + 0.5, "bias": rng.standard_normal(5).astype(np.float32),
          "mean": rng.standard_normal(5).astype(np.float32), "var": rng.random(5).astype(np.float32) + 0.1}
    xt = _nchw(x)
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_nhwc(tl.conv2d(xt, from_jax(conv), padding=1)),
                               np.asarray(jl.conv2d(jnp.asarray(x), conv, padding=1)), **tol)
    np.testing.assert_allclose(tl.linear(torch.from_numpy(x[0, 0]), from_jax(lin)).numpy(),
                               np.asarray(jl.linear(jnp.asarray(x[0, 0]), lin)), **tol)
    np.testing.assert_allclose(_nhwc(tl.batchnorm(xt, from_jax(bn))),
                               np.asarray(jl.batchnorm(jnp.asarray(x), bn)), **tol)
    np.testing.assert_allclose(_nhwc(tl.avg_pool(xt, 2)), np.asarray(jl.avg_pool(jnp.asarray(x), 2)), **tol)
    for out_hw in ((4, 6), (3, 5), (7, 7)):
        np.testing.assert_allclose(_nhwc(tl.adaptive_avg_pool(xt, out_hw)),
                                   np.asarray(jl.adaptive_avg_pool(jnp.asarray(x), out_hw)), **tol)
    np.testing.assert_array_equal(_nhwc(tl.upsample_nearest(xt, 2)),
                                  np.asarray(jl.upsample_nearest(jnp.asarray(x), 2)))
    np.testing.assert_allclose(_nhwc(tl.leaky_relu(xt)), np.asarray(jl.leaky_relu(jnp.asarray(x))), **tol)


@pytest.mark.parametrize("size,truncate,bn", [(32, True, False), (32, False, False), (36, False, False),
                                              (32, True, True)])
def test_vgg19_taps_float32_match_jax(vgg_params, size, truncate, bn):
    """36 px reaches pool3 at an odd extent (9), which takes the plain pool;
    ``bn`` is the vgg19_bn layer table with eval batchnorm after each conv."""
    jp, tp = vgg_params
    if bn:
        rng = np.random.default_rng(1)
        jp = dict(jp)
        for name in [k for k in jp if k.startswith("conv")]:
            c = jp[name]["b"].shape[0]
            jp["bn" + name[4:]] = {"scale": rng.random(c).astype(np.float32) + 0.5,
                                   "bias": rng.standard_normal(c).astype(np.float32) * 0.1,
                                   "mean": rng.standard_normal(c).astype(np.float32) * 0.1,
                                   "var": rng.random(c).astype(np.float32) + 0.5}
        tp = from_jax(jp)
    x = np.random.default_rng(size).random((2, size, size, 3)).astype(np.float32)
    jf, jc, js = JVGG.apply(jp, jnp.asarray(x), truncate=truncate, bn=bn)
    tf, tc, ts = VGG19.apply(tp, _nchw(x), truncate=truncate, bn=bn)
    for a, b in zip([tf, *tc, *ts], [jf, *jc, *js]):
        np.testing.assert_allclose(_nhwc(a), np.asarray(b), rtol=1e-4, atol=1e-5)


def test_vgg19_mask_and_input_gradient_match_jax(vgg_params):
    """The NST loss gradient through the fused relu+pool, the tie-to-all
    pools and the mask multiply."""
    jp, tp = vgg_params
    rng = np.random.default_rng(4)
    x = rng.random((2, 32, 32, 3)).astype(np.float32)
    mask = (rng.random((2, 32, 32, 1)) > 0.2).astype(np.float32)
    tgt = rng.random((2, 32, 32, 3)).astype(np.float32)

    def j_loss(v):
        _, c, s = JVGG.apply(jp, v, mask=jnp.asarray(mask), truncate=True)
        _, ct, st = JVGG.apply(jp, jnp.asarray(tgt), mask=jnp.asarray(mask), truncate=True)
        return jlosses.content_loss_l2(c, ct) + jlosses.style_loss_bn(s, [jlosses.style_stats(f) for f in st])

    j_g = np.asarray(jax.jit(jax.grad(j_loss))(jnp.asarray(x)))
    xt = _nchw(x).requires_grad_(True)
    with torch.no_grad():
        _, ct, st = VGG19.apply(tp, _nchw(tgt), mask=_nchw(mask), truncate=True)
    _, c, s = VGG19.apply(tp, xt, mask=_nchw(mask), truncate=True)
    loss = tlosses.content_loss_l2(c, ct) + tlosses.style_loss_bn(s, [tlosses.style_stats(f) for f in st])
    (g,) = torch.autograd.grad(loss, xt)
    np.testing.assert_allclose(_nhwc(g), j_g, rtol=1e-3, atol=1e-5 * np.abs(j_g).max())
    np.testing.assert_allclose(loss.item(), float(jax.jit(j_loss)(jnp.asarray(x))), rtol=1e-5)


def test_vgg19_taps_bfloat16_match_jax(vgg_params):
    jp, tp = vgg_params
    x = np.random.default_rng(5).random((2, 32, 32, 3)).astype(np.float32)
    _, jc, js = JVGG.apply(jp, jnp.asarray(x), compute_dtype=jnp.bfloat16, truncate=True)
    _, tc, ts = VGG19.apply(tp, _nchw(x), compute_dtype=torch.bfloat16, truncate=True)
    for a, b in zip([*tc, *ts], [*jc, *js]):
        assert a.dtype == torch.bfloat16
        want = np.asarray(b.astype(jnp.float32))
        assert np.abs(_nhwc(a) - want).max() <= 0.05 * np.abs(want).max()


def test_vgg19_init_is_seeded_he_normal():
    a = VGG19.init(torch.Generator().manual_seed(3))
    b = VGG19.init(torch.Generator().manual_seed(3))
    assert all(torch.equal(a[k]["w"], b[k]["w"]) for k in a)
    w = a["conv3_1"]["w"]
    assert w.shape == (256, 128, 3, 3) and not a["conv3_1"]["b"].any()
    np.testing.assert_allclose(float(w.std()), np.sqrt(2.0 / (9 * 256)), rtol=0.02)


def test_ritnet_pretrained_matches_jax():
    """The preprocessing equals the eager JAX transform exactly (under jit,
    XLA turns its divisions by 255 into reciprocal multiplies and moves a
    few pixels by one level, so the oracle runs eagerly); the network runs
    jitted on the same input."""
    imgs, _, _ = synthetic_eye_batch(2, 64, 96, num_users=2, seed=3)
    imgs = (np.round(imgs * 255) / 255).astype(np.float32)  # frames are u8 at the source
    jp = JRITnet.pretrained()
    j_in = np.asarray(JRITnet.transform(jnp.asarray(imgs)))
    logits_j = np.asarray(jax.jit(JRITnet.forward)(jp, jnp.asarray(j_in)))
    tp = RITnet.pretrained()
    t_in = RITnet.transform(torch.from_numpy(imgs))
    np.testing.assert_array_equal(_nhwc(t_in), j_in)
    logits_t = _nhwc(RITnet.forward(tp, t_in))
    np.testing.assert_allclose(logits_t, logits_j, rtol=1e-3, atol=1e-3 * np.abs(logits_j).max())
    t_lab = RITnet.apply(tp, torch.from_numpy(imgs)).numpy()
    assert t_lab.shape == (2, 64, 96)
    assert (t_lab == np.argmax(logits_j, axis=-1)).mean() >= 0.995


def test_classifier_heads_match_jax():
    """Both heads at a narrow hidden width (the apply functions take any),
    Classifier1 on 14x14 features (adaptive pool) in NCHW flatten order."""
    rng = np.random.default_rng(6)

    def mlp(din):
        dims = (din, 32, 32, 5)
        return {f"fc{i}": {"w": (rng.standard_normal(dims[i : i + 2]) / np.sqrt(dims[i])).astype(np.float32),
                           "b": rng.standard_normal(dims[i + 1]).astype(np.float32)} for i in range(3)}

    p1, p2 = mlp(512 * 49), mlp(1920)
    final = rng.random((2, 14, 14, 512)).astype(np.float32)
    style = [rng.random((2, s, s, c)).astype(np.float32) for s, c in ((8, 64), (4, 128), (2, 256), (2, 512))]
    np.testing.assert_allclose(Classifier1.apply(from_jax(p1), _nchw(final)).numpy(),
                               np.asarray(JC1.apply(p1, jnp.asarray(final))), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(Classifier2.features([_nchw(f) for f in style]).numpy(),
                               np.asarray(JC2.features([jnp.asarray(f) for f in style])), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(Classifier2.apply(from_jax(p2), [_nchw(f) for f in style]).numpy(),
                               np.asarray(JC2.apply(p2, [jnp.asarray(f) for f in style])), rtol=1e-5, atol=1e-5)
    c1 = Classifier1.init(torch.Generator().manual_seed(0), num_class=7)
    assert c1["fc0"]["w"].shape == (4096, 25088) and c1["fc2"]["w"].shape == (7, 4096)
