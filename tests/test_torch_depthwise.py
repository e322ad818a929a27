"""CPU parity of the port's fused depthwise op and MBConv block against JAX.

The port's ``dw_conv_bn_silu`` on a CPU tensor is its plain version; it is
held to the JAX package's Pallas kernel in interpret mode (the TPU kernel's
own CPU form) at the shapes of ``tests/test_layers.py`` plus one odd shape
(H = 13, C = 40), in float32 with rtol 1e-5 and in bfloat16 within the JAX
test's 0.05.  ``_mbconv`` is held to the JAX block with ``PALLAS_DW``
off (grouped XLA conv) in float32 with rtol 1e-4 of the output's scale.

Gradients: the op's (x, w, a, b) against ``jax.grad`` of the JAX package's
XLA form of it (the grouped conv of ``_mbconv``, the folded batchnorm,
SiLU), and ``_mbconv``'s (x and every parameter) against ``jax.grad`` of the
JAX block, in float32 within 1e-3 of each gradient's largest magnitude
(f32 sums over B, H, W taken in another order).

Launch plans: the forward's (``plan``) and the backward kernels'
(``plan_bwd``) at every B7 shape and at the kernels' edge cases cover each
output (and each per-tile partial) once and fit the card; on CPU tensors
the backward is the plain version and launches nothing.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from iris_style_transfer_tpu.models import efficientnet as jeff
from iris_style_transfer_tpu.ops import pallas_depthwise as jdw

from iris_style_transfer_tpu_torch.models import efficientnet as teff
from iris_style_transfer_tpu_torch.models.port import from_jax, to_jax
from iris_style_transfer_tpu_torch.ops import depthwise as tdw


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).float().numpy()


def _inputs(shape, k, seed):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x = rng.standard_normal(shape).astype(np.float32)
    w = (rng.standard_normal((k, k, 1, c)) * 0.2).astype(np.float32)
    a = rng.uniform(0.5, 2.0, c).astype(np.float32)
    b = rng.standard_normal(c).astype(np.float32)
    return x, w, a, b


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,k", [((2, 16, 20, 256), 3), ((2, 16, 20, 64), 5), ((1, 13, 7, 40), 5),
                                     ((1, 9, 11, 36), 3), ((1, 9, 11, 36), 5)])  # C % 8 != 0
def test_dw_conv_bn_silu_matches_pallas_interpret(shape, k, dtype):
    x, w, a, b = _inputs(shape, k, seed=18 + k)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = jdw.dw_conv_bn_silu(jnp.asarray(x).astype(jdt), jnp.asarray(w).astype(jdt), jnp.asarray(a),
                               jnp.asarray(b), k, interpret=True)
    want = np.asarray(want.astype(jnp.float32))
    tw = from_jax({"w": w})["w"]
    assert tuple(tw.shape) == (shape[-1], 1, k, k)
    got = tdw.dw_conv_bn_silu(_nchw(x).to(tdt), tw.to(tdt), torch.from_numpy(a), torch.from_numpy(b), k)
    assert got.dtype == tdt and got.is_contiguous(memory_format=torch.channels_last)
    if dtype == "float32":
        np.testing.assert_allclose(_nhwc(got), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    else:
        np.testing.assert_allclose(_nhwc(got), want, rtol=0.05, atol=0.05)


def test_dw_cpu_call_launches_no_kernel_and_refuses_grad():
    """A CPU call launches no kernel, and grad mode is no longer refused:
    x, w, a and b all get the gradient of autograd through the plain
    version (the name predates the backward)."""
    x, w, a, b = _inputs((1, 5, 6, 8), 3, seed=0)
    args = (torch.from_numpy(w).permute(3, 2, 0, 1), torch.from_numpy(a), torch.from_numpy(b), 3)
    before = dict(tdw.LAUNCHES)
    tdw.dw_conv_bn_silu(_nchw(x), *args)
    assert tdw.LAUNCHES == before
    leaves = [_nchw(x).requires_grad_(True), *(t.clone().requires_grad_(True) for t in args[:3])]
    got = torch.autograd.grad(tdw.dw_conv_bn_silu(*leaves, 3).square().sum(), leaves)
    want = torch.autograd.grad(tdw.dw_conv_bn_silu_plain(*leaves, 3).square().sum(), leaves)
    for g, v in zip(got, want):
        torch.testing.assert_close(g, v, rtol=1e-5, atol=1e-5 * v.abs().max().item())
    with torch.no_grad():
        assert tdw.dw_conv_bn_silu(*leaves, 3).grad_fn is None  # frozen use records nothing
    with pytest.raises(ValueError, match="k must be 3 or 5"):
        tdw.dw_conv_bn_silu(_nchw(x), args[0], args[1], args[2], 7)
    with pytest.raises(ValueError, match="float32"):
        tdw.dw_conv_bn_silu(_nchw(x), args[0], args[1].double(), args[2], 3)
    with pytest.raises(ValueError, match="unsupported device"):
        tdw.dw_conv_bn_silu(_nchw(x).to("meta"), args[0], args[1], args[2], 3)


def _jax_dw_conv_bn_silu(x, w, a, b, k):
    """The JAX package's XLA form of the fused op, as ``_mbconv`` computes it
    with ``PALLAS_DW`` off: the grouped conv (symmetric (k - 1) / 2 padding
    is TF-"same" at stride 1), the folded batchnorm, SiLU."""
    p = (k - 1) // 2
    acc = jax.lax.conv_general_dilated(x, w, (1, 1), [(p, p), (p, p)], dimension_numbers=("NHWC", "HWIO", "NHWC"),
                                       feature_group_count=x.shape[-1])
    return jax.nn.silu(acc * a + b)


def _close(got, want, rtol=1e-3):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=rtol, atol=rtol * np.abs(want).max())


@pytest.mark.parametrize("shape,k", [((2, 9, 11, 16), 3), ((1, 13, 7, 40), 5), ((1, 9, 11, 36), 3),
                                     ((2, 6, 5, 8), 5), ((1, 1, 17, 8), 3)])
def test_dw_conv_bn_silu_gradients_match_jax(shape, k):
    """The Function's gradient in x, w, a and b against jax.grad of the JAX
    package's XLA form, under a random cotangent."""
    x, w, a, b = _inputs(shape, k, seed=30 + k)
    ct = np.random.default_rng(k).standard_normal(shape).astype(np.float32)
    want = jax.grad(lambda *v: jnp.sum(_jax_dw_conv_bn_silu(*v, k) * ct), argnums=(0, 1, 2, 3))(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(a), jnp.asarray(b))
    leaves = [_nchw(x).requires_grad_(True), from_jax({"w": w})["w"].requires_grad_(True),
              torch.from_numpy(a).requires_grad_(True), torch.from_numpy(b).requires_grad_(True)]
    dx, dw, da, db = torch.autograd.grad(tdw.dw_conv_bn_silu(*leaves, k), leaves, _nchw(ct))
    assert dx.is_contiguous(memory_format=torch.channels_last) and dw.shape == (shape[-1], 1, k, k)
    _close(_nhwc(dx), want[0])
    _close(dw[:, 0].permute(1, 2, 0)[:, :, None, :].numpy(), want[1])  # (C, 1, k, k) -> (k, k, 1, C)
    _close(da.numpy(), want[2])
    _close(db.numpy(), want[3])


def test_within_tolerance_bounds():
    y = torch.linspace(-3, 3, 4001)
    assert tdw.within_tolerance(y + 1e-6 * y.abs().max(), y)[0]
    assert not tdw.within_tolerance(y + 1e-4, y)[0]
    yb = y.to(torch.bfloat16)
    up = torch.nextafter(yb.float(), torch.tensor(float("inf"))).to(torch.bfloat16)  # rounds back
    assert tdw.within_tolerance(up, yb) == (True, 0.0)
    one_ulp = yb.clone()
    one_ulp[100] = (yb[100].float() * (1 + 2**-7)).to(torch.bfloat16)
    assert tdw.within_tolerance(one_ulp, yb)[0]
    many = yb.clone()
    many[:100] = (yb[:100].float() * 1.1).to(torch.bfloat16)
    assert not tdw.within_tolerance(many, yb)[0]


def _b7_shapes():
    """(k, C, H, W) of B7's stride-1 depthwise convs on a 416x640 frame."""
    return sorted(teff.depthwise_shapes())


def test_b7_depthwise_shapes():
    """The shapes the chip checks time the kernel at: B7's 51 stride-1
    depthwise blocks over 10 distinct shapes, C a multiple of 8."""
    shapes = teff.depthwise_shapes()
    assert sum(shapes.values()) == 51 and len(shapes) == 10
    assert shapes[(3, 288, 104, 160)] == 6 and all(c % 8 == 0 for _, c, _, _ in shapes)
    n_stride1 = sum(1 for _, _, s, _, _ in teff.BLOCK_ARGS if s == 1)
    assert n_stride1 == 51


_EDGE_SHAPES = [((3, 36, 9, 11), 3, True), ((3, 36, 9, 11), 5, True), ((2, 64, 6, 3), 3, True), ((2, 64, 6, 3), 5, True),
                ((2, 40, 1, 17), 3, True), ((2, 40, 1, 17), 5, True), ((2, 64, 9, 12), 3, False), ((1, 37, 9, 11), 3, True),
                ((1, 8 * 37, 5, 300), 5, True), ((5, 1, 1, 1), 3, True)]


def _assert_covers_once(pl, shape):
    """A plan's channels (slice, thread's vector, lane), rows (tile, thread
    row, the thread's rows ty, ty + rows_t, ... below tile_h) and columns
    (tile, thread run, pixel of the run) each hit every index once."""
    bsz, c, h, w = shape
    pe = pl.cvb * pl.vec
    assert c % pe == 0 and pl.slices == c // pe
    assert pl.tile_w == pl.runs * tdw.RUN and pl.blocks == bsz * pl.tiles_h * pl.tiles_w * pl.slices
    assert pl.threads == pl.cvb * pl.runs * pl.rows_t <= tdw.MAX_THREADS
    chans = [s * pe + cv * pl.vec + v for s in range(pl.slices) for cv in range(pl.cvb) for v in range(pl.vec)]
    assert sorted(chans) == list(range(c))
    rows = [i * pl.tile_h + r for i in range(pl.tiles_h) for ty in range(pl.rows_t)
            for r in range(ty, pl.tile_h, pl.rows_t) if i * pl.tile_h + r < h]
    assert sorted(rows) == list(range(h))
    cols = [i * pl.tile_w + run * tdw.RUN + p for i in range(pl.tiles_w) for run in range(pl.runs)
            for p in range(tdw.RUN) if i * pl.tile_w + run * tdw.RUN + p < w]
    assert sorted(cols) == list(range(w))


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("shape,k,aligned", [((32, c, h, w), k, True) for k, c, h, w in _b7_shapes()] + _EDGE_SHAPES)
def test_dw_plan_covers_every_output_once_and_fits(shape, k, aligned, itemsize):
    """The kernel's launch plan: channels (slice, thread's vector, lane)
    and pixels (tile, thread, item) each hit once, a block within the
    kernel's 256 threads and the plan's shared-memory cap, channel vectors
    (whole 16-byte copies) only where C and the alignment allow them."""
    bsz, c, h, w = shape
    pl = tdw.plan(shape, k, itemsize, aligned)
    assert pl.vec == (4 if c % 8 == 0 and aligned else 1)
    pe = pl.cvb * pl.vec
    smem = ((k * k + 2) * pe + 3) // 4 * 4 * 4 + (pl.tile_h + k - 1) * (pl.tile_w + k - 1) * pe * itemsize
    assert pl.smem == smem <= tdw.MAX_SMEM
    _assert_covers_once(pl, shape)
    if bsz == 32 and c > 8:  # a B7 shape: several waves of blocks on the 132 SMs
        assert pl.blocks >= 8 * 132


def _r16(n):
    return (n + 15) // 16 * 16


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("shape,k,aligned,b7", [((bsz, c, h, w), k, True, True) for bsz in (2, 32)
                                                for k, c, h, w in _b7_shapes()]
                         + [(shape, k, aligned, False) for shape, k, aligned in _EDGE_SHAPES])
def test_dw_plan_bwd_covers_every_output_once_and_fits(shape, k, aligned, b7, itemsize):
    """The backward's launches: the tile pass covers every pixel and
    channel once, so every (spatial tile, channel) partial row of the
    workspace is written once; its dw items (channel, dy, row group) cover
    every (channel, tap row, tile row) once; the dx pass is the forward's
    plan of the f32 ``a * dz`` and covers every dx element once; the tile
    pass fits 256 threads and ``MAX_SMEM_BWD`` (x's halo tile, ``a * dz``'s
    f32 tile, each thread's da/db partials and each (group, tap,
    channel)'s dw partial, 16-byte aligned regions); the workspace is
    ``tiles * (k * k + 2) * C`` floats, at B7's shapes no more than
    ``a * dz``'s own; the reduce grid's rows fit its 65,535 limit."""
    bsz, c, h, w = shape
    pb = tdw.plan_bwd(shape, k, itemsize, aligned)
    tl = pb.tile
    assert tl.vec == (4 if c % 8 == 0 and aligned else 1)
    _assert_covers_once(tl, shape)
    pe = tl.cvb * tl.vec
    assert pb.groups == max(1, tl.threads // (pe * k))
    smem = (((k * k + 2) * pe + 3) // 4 * 4 * 4 + _r16((tl.tile_h + k - 1) * (tl.tile_w + k - 1) * pe * itemsize)
            + _r16(tl.tile_h * tl.tile_w * pe * 4) + _r16(tl.threads * 2 * tl.vec * 4) + pb.groups * k * k * pe * 4)
    assert tl.smem == smem <= tdw.MAX_SMEM_BWD
    # partial rows: block (spatial tile t, slice s) writes channels s * pe .. s * pe + pe - 1 of row t
    assert pb.tiles == bsz * tl.tiles_h * tl.tiles_w
    partials = [(t, s * pe + j) for t in range(pb.tiles) for s in range(tl.slices) for j in range(pe)]
    assert len(partials) == len(set(partials)) == pb.tiles * c
    assert pb.workspace == pb.tiles * (k * k + 2) * c
    # dw items: every (channel, dy, tile row) once over the block's items
    items = [(j, dy, r) for it in range(pb.groups * k * pe) for j, dy, g in [(it % pe, it // pe % k, it // (pe * k))]
             for r in range(g, tl.tile_h, pb.groups)]
    assert sorted(items) == [(j, dy, r) for j in range(pe) for dy in range(k) for r in range(tl.tile_h)]
    assert pb.dx == tdw.plan(shape, k, 4, True)
    _assert_covers_once(pb.dx, shape)
    assert pb.reduce_blocks == -(-c // tdw.REDUCE_LANES) * (k * k + 2) and k * k + 2 <= 65535
    if b7:
        assert pb.workspace <= bsz * c * h * w
        assert tl.blocks >= 132  # a wave of blocks on the 132 SMs at bs 2


def test_dw_cpu_backward_launches_no_kernel():
    """On CPU tensors the Function's backward is the plain version itself:
    no backward kernel launches and no cotangent is copied, also for an
    NCHW-contiguous cotangent and for each subset of gradients."""
    x, w, a, b = _inputs((2, 6, 7, 8), 5, seed=3)
    args = [_nchw(x), from_jax({"w": w})["w"], torch.from_numpy(a), torch.from_numpy(b)]
    gy = torch.from_numpy(np.random.default_rng(4).standard_normal((2, 8, 6, 7)).astype(np.float32))
    before, copies = dict(tdw.BWD_LAUNCHES), dict(tdw.COPIES)
    for needs in ((True, True, True, True), (True, False, False, False), (False, True, True, False)):
        got = tdw.dw_conv_bn_silu_grad(*args, 5, gy, needs)
        want = tdw.dw_conv_bn_silu_bwd(*args, 5, gy, needs)
        assert all(g is None if v is None else torch.equal(g, v) for g, v in zip(got, want))
        assert [g is not None for g in got] == list(needs)
    leaves = [t.clone().requires_grad_(True) for t in args]
    grads = torch.autograd.grad(tdw.dw_conv_bn_silu(*leaves, 5), leaves, gy)
    assert all(torch.equal(g, v) for g, v in zip(grads, tdw.dw_conv_bn_silu_bwd(*args, 5, gy)))
    assert tdw.BWD_LAUNCHES == before and tdw.COPIES == copies
    with pytest.raises(ValueError, match="unsupported device"):
        tdw.dw_conv_bn_silu_grad(args[0].to("meta"), *args[1:], 5, gy.to("meta"))


def _fill(shapes, rng):
    """Random values for a JAX parameter tree of ShapeDtypeStructs:
    fan-in scaled conv weights, batchnorm away from the identity."""

    def leaf(path, s):
        name = getattr(path[-1], "key", "")
        if name == "w":
            return (rng.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        return (rng.standard_normal(s.shape) * 0.1).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@pytest.mark.parametrize("expand,k,stride,cin,cout,h", [
    (1, 3, 1, 16, 8, 16),   # B7's first block: no expand conv
    (6, 3, 2, 8, 12, 16),   # stride 2, TF-"same" pad (0, 1)
    (6, 5, 1, 8, 8, 16),    # the fused op, with the residual
    (6, 5, 2, 8, 16, 13),   # stride 2 at an odd height: pad (2, 2) x (1, 2)
])
def test_mbconv_matches_jax(expand, k, stride, cin, cout, h):
    assert not jeff.PALLAS_DW
    rng = np.random.default_rng(k * 10 + stride)
    shapes = jax.eval_shape(lambda key: jeff._init_mbconv(key, expand, k, cin, cout, jnp.float32),
                            jax.random.PRNGKey(0))
    p = _fill(shapes, rng)
    x = rng.standard_normal((2, h, 20, cin)).astype(np.float32)
    want = np.asarray(jeff._mbconv(p, jnp.asarray(x), expand, k, stride, cin, cout))
    xt = _nchw(x).contiguous(memory_format=torch.channels_last)
    got = _nhwc(teff._mbconv(from_jax(p), xt, expand, k, stride, cin, cout))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("expand,k,stride,cin,cout,h", [
    (1, 3, 1, 16, 8, 16),   # no expand conv; the fused op
    (6, 3, 2, 8, 12, 16),   # stride 2: the plain conv path
    (6, 5, 1, 8, 8, 16),    # the fused op, with the residual
    (6, 5, 2, 8, 16, 13),   # stride 2 at an odd height
])
def test_mbconv_gradients_match_jax(expand, k, stride, cin, cout, h):
    """The gradient of the block in x and in every parameter (through the
    folded batchnorm into a and b) against jax.grad of the JAX block."""
    rng = np.random.default_rng(k * 10 + stride + 1)
    shapes = jax.eval_shape(lambda key: jeff._init_mbconv(key, expand, k, cin, cout, jnp.float32),
                            jax.random.PRNGKey(0))
    p = _fill(shapes, rng)
    x = rng.standard_normal((2, h, 20, cin)).astype(np.float32)
    out_shape = jax.eval_shape(lambda v: jeff._mbconv(p, v, expand, k, stride, cin, cout), x).shape
    ct = rng.standard_normal(out_shape).astype(np.float32)
    gx_j, gp_j = jax.grad(lambda v, q: jnp.sum(jeff._mbconv(q, v, expand, k, stride, cin, cout) * ct),
                          argnums=(0, 1))(jnp.asarray(x), p)
    tp = from_jax(p)
    leaves, treedef = jax.tree_util.tree_flatten(tp)
    for t in leaves:
        t.requires_grad_(True)
    xt = _nchw(x).contiguous(memory_format=torch.channels_last).requires_grad_(True)
    out = teff._mbconv(tp, xt, expand, k, stride, cin, cout)
    grads = torch.autograd.grad(out, [xt, *leaves], _nchw(ct), allow_unused=True)
    _close(_nhwc(grads[0]), gx_j)
    got = to_jax(jax.tree_util.tree_unflatten(
        treedef, [torch.zeros_like(t) if g is None else g for t, g in zip(leaves, grads[1:])]))
    jax.tree_util.tree_map(_close, got, jax.tree_util.tree_map(np.asarray, gp_j))
