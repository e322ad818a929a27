"""CPU parity of the port's conv1_1 (``ops/conv1.py``) against the JAX
package.

The plain version and the ``Conv1`` autograd Function are held to
``layers.conv2d_mxu_dx`` (the forward, and the input gradient of its custom
VJP ``_conv_small_cin_bwd``) and to ``layers.conv2d``'s weight and bias
gradients; the Pallas ``conv1_fwd`` runs in interpret mode.  Tolerance:
``1e-5 * max|reference|`` in float32 (the 9*C_in products summed in another
order; the weight gradient sums B*H*W products).  VGG19 at 32x32 is held
to JAX as in ``tests/test_torch_models.py`` (rtol 1e-4 / atol 1e-5 on the
taps, 1e-3 of the largest element on the input gradient), with conv1_1
taken by ``Conv1``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from iris_style_transfer_tpu.models import VGG19 as JVGG
from iris_style_transfer_tpu.models import layers as jl
from iris_style_transfer_tpu.ops import pallas_conv1

from iris_style_transfer_tpu_torch.models import VGG19
from iris_style_transfer_tpu_torch.models.port import from_jax
from iris_style_transfer_tpu_torch.ops import conv1 as tc


def _inputs(cin, cout=64, shape=(2, 16, 20), seed=0):
    rng = np.random.default_rng(seed)
    b, h, w = shape
    x = rng.standard_normal((b, h, w, cin)).astype(np.float32)
    wt = (rng.standard_normal((3, 3, cin, cout)) * 0.3).astype(np.float32)
    bias = rng.standard_normal(cout).astype(np.float32)
    ct = rng.standard_normal((b, h, w, cout)).astype(np.float32)
    return x, wt, bias, ct


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("cin", [1, 3, 4])
def test_conv1_forward_and_vjp_match_jax(cin):
    x, wt, bias, ct = _inputs(cin)
    p = {"w": jnp.asarray(wt), "b": jnp.asarray(bias)}
    y_j, pull = jax.vjp(lambda xv: jl.conv2d_mxu_dx(xv, p), jnp.asarray(x))
    (dx_j,) = pull(jnp.asarray(ct))
    _, pull_wb = jax.vjp(lambda wv, bv: jl.conv2d(jnp.asarray(x), {"w": wv, "b": bv}, stride=1, padding=1),
                         p["w"], p["b"])
    dw_j, db_j = pull_wb(jnp.asarray(ct))

    tp = from_jax({"w": wt, "b": bias})
    xt = _nchw(x).contiguous(memory_format=torch.channels_last).requires_grad_(True)
    w_t, b_t = tp["w"].requires_grad_(True), tp["b"].requires_grad_(True)
    y = tc.Conv1.apply(xt, w_t, b_t)
    _close(_nhwc(y), np.asarray(y_j))
    _close(_nhwc(tc.conv1_fwd_plain(xt.detach(), w_t.detach(), b_t.detach())), np.asarray(y_j))
    dx, dw, db = torch.autograd.grad(y, (xt, w_t, b_t), _nchw(ct))
    _close(_nhwc(dx), np.asarray(dx_j))
    _close(dw.permute(2, 3, 1, 0).numpy(), np.asarray(dw_j))  # OIHW -> HWIO
    _close(db.numpy(), np.asarray(db_j))


def test_conv1_backward_computes_only_what_is_asked():
    x, wt, bias, ct = _inputs(3, cout=8, shape=(1, 6, 7))
    tp = from_jax({"w": wt, "b": bias})
    seen = []
    real = torch.ops.aten.convolution_backward

    class Spy:
        def __call__(self, *args):
            seen.append(list(args[-1]))
            return real(*args)

    xt = _nchw(x).contiguous(memory_format=torch.channels_last)
    old, torch.ops.aten.convolution_backward = real, Spy()
    try:
        y = tc.Conv1.apply(xt.requires_grad_(True), tp["w"], tp["b"])  # the NST closure: dx only
        torch.autograd.grad(y, xt, _nchw(ct))
        y = tc.Conv1.apply(xt.detach(), tp["w"].requires_grad_(True), tp["b"].requires_grad_(True))  # training
        torch.autograd.grad(y, (tp["w"], tp["b"]), _nchw(ct))
    finally:
        torch.ops.aten.convolution_backward = old
    assert seen == [[True, False, False], [False, True, True]]


def test_pallas_conv1_interpret_matches_the_port():
    """The TPU kernel itself, in interpret mode at a shape its block picker
    accepts, against the port's plain version and XLA's conv."""
    x, wt, bias, _ = _inputs(3)
    assert pallas_conv1._pick(2, 16, 20, 4, 64, 4) is not None
    y_pl = np.asarray(pallas_conv1.conv1_fwd(jnp.asarray(x), jnp.asarray(wt), jnp.asarray(bias), interpret=True))
    y_xla = np.asarray(jl.conv2d(jnp.asarray(x), {"w": jnp.asarray(wt), "b": jnp.asarray(bias)}, stride=1, padding=1))
    _close(y_pl, y_xla)
    tp = from_jax({"w": wt, "b": bias})
    _close(_nhwc(tc.conv1_fwd(_nchw(x).contiguous(memory_format=torch.channels_last), tp["w"], tp["b"])), y_pl)


def test_conv1_checks_its_arguments():
    x = torch.zeros(1, 5, 4, 4)
    with pytest.raises(ValueError, match="C_in"):
        tc.conv1_fwd(x, torch.zeros(8, 5, 3, 3), torch.zeros(8))
    with pytest.raises(ValueError, match="OIHW"):
        tc.conv1_fwd(x[:, :3], torch.zeros(8, 3, 5, 5), torch.zeros(8))
    with pytest.raises(ValueError, match="bias"):
        tc.conv1_fwd(x[:, :3], torch.zeros(8, 3, 3, 3), torch.zeros(7))
    with pytest.raises(ValueError, match="CUDA"):
        tc._kernel_fwd(x[:, :3], torch.zeros(8, 3, 3, 3), torch.zeros(8))


def _has_node(fn, name, seen=None):
    seen = set() if seen is None else seen
    if fn is None or fn in seen:
        return False
    seen.add(fn)
    return name in type(fn).__name__ or any(_has_node(f, name, seen) for f, _ in fn.next_functions)


def test_vgg19_takes_conv1_for_conv1_1_and_matches_jax():
    jp = jax.tree.map(np.asarray, jax.jit(JVGG.init)(jax.random.PRNGKey(0)))
    img = np.random.default_rng(1).uniform(size=(2, 32, 32, 3)).astype(np.float32)
    ct = np.random.default_rng(2).standard_normal((2, 4, 4, 512)).astype(np.float32)

    def jax_fn(x):
        _, c, s = JVGG.apply(jp, x, truncate=True)
        return c[0], s

    (c_j, s_j), pull = jax.vjp(jax_fn, jnp.asarray(img))
    zeros = [jnp.zeros_like(f) for f in s_j]
    (dx_j,) = pull((jnp.asarray(ct), zeros))

    xt = _nchw(img).requires_grad_(True)
    _, c, s = VGG19.apply(from_jax(jp), xt, truncate=True)
    assert _has_node(c[0].grad_fn, "Conv1Backward")
    for got, want in zip([c[0], *s], [c_j, *s_j]):
        np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=1e-4, atol=1e-5)
    (dx,) = torch.autograd.grad(c[0], xt, _nchw(ct))
    dx_j = np.asarray(dx_j)
    np.testing.assert_allclose(_nhwc(dx), dx_j, rtol=0, atol=1e-3 * np.abs(dx_j).max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(3, 3, 37, 53), (2, 1, 16, 32), (1, 4, 1, 1)])
def test_conv1_plan_covers_every_output_pixel_once(shape, dtype):
    b, _, h, w = shape
    pl = tc.plan(shape, dtype)
    assert pl.kernel == ("mma" if dtype == torch.bfloat16 else "fma") and pl.tiles == b * pl.tiles_h * pl.tiles_w
    px = []
    for t in range(pl.tiles):
        image, r0, c0 = tc.tile_origin(pl, t)
        px += [(image, r, cc) for r in range(r0, min(r0 + tc.TILE_H, h)) for cc in range(c0, min(c0 + tc.TILE_W, w))]
    assert sorted(px) == [(i, r, cc) for i in range(b) for r in range(h) for cc in range(w)]


def test_conv1_plan_takes_any_batch():
    """No 65535 batch limit: B = 70,000 is planned on both kernels (not
    run), its last tile in the last image; only the f32 kernel's 1-D grid
    past 2^31 - 1 blocks raises."""
    for dtype in (torch.float32, torch.bfloat16):
        pl = tc.plan((70_000, 3, 224, 224), dtype)
        assert pl.tiles == 70_000 * 14 * 7 and tc.tile_origin(pl, pl.tiles - 1) == (69_999, 208, 192)
    assert tc.plan((2**31, 3, 16, 32), torch.bfloat16).tiles == 2**31
    with pytest.raises(ValueError, match="2\\^31 - 1"):
        tc.plan((2**31, 3, 16, 32), torch.float32)
