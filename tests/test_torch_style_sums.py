"""The BN style loss's per-channel sums (``ops/style_sums.py``) and their
gradient.

CPU (tier 1): the plain version against float64 sums (within 1e-6 of
sum|terms| per (b, c)) and its gradient bit-equal to autograd through the
eager float32 chain the port ran before; ``style_stats``,
``style_loss_bn`` and ``Classifier2.features`` give that chain's loss and
gradient bit for bit; the launch plan at the style taps' shapes, with the
kernels' index math emulated in numpy at small shapes (every element read
once).  The card (marker ``cuda``; skipped without CUDA): the kernels'
sums within the same bound and bit-equal over two runs, the gradient
bit-exact with the plain version, in both layouts, and the NST's classic
path launching them::

    python -m pytest tests/test_torch_style_sums.py -m cuda --noconftest -q

This file imports no JAX.
"""

import numpy as np
import pytest
import torch

from iris_style_transfer_tpu_torch.models.classifiers import Classifier2
from iris_style_transfer_tpu_torch.ops import losses
from iris_style_transfer_tpu_torch.ops import style_sums as ss

# the 2019 style taps relu1_1..relu4_1 at batch 2, B = 1 with odd H and W, and C off the 16-byte vector
CPU_SHAPES = [(2, 64, 224, 224), (2, 128, 112, 112), (2, 256, 56, 56), (2, 512, 28, 28), (1, 5, 7, 9), (3, 12, 13, 11)]
DTYPES = [torch.bfloat16, torch.float32]
LAYOUTS = ["nhwc", "nchw"]


def _tap(shape, dtype, layout, seed=0, device="cpu"):
    """A relu-like tap (zeros and positives) with planted exact zeros and a
    few large values, in ``layout``."""
    gen = torch.Generator().manual_seed(seed)
    b, c, h, w = shape
    x = torch.relu(torch.randn((b, h, w, c), generator=gen)) * 3.0
    x[:, 0, :, :] = 0.0
    x[:, -1, -1, :] = 6.0e4
    x = x.to(dtype).permute(0, 3, 1, 2)
    x = x.contiguous() if layout == "nchw" else x.contiguous(memory_format=torch.channels_last)
    return x.to(device)


def _cotangents(shape, seed=1, device="cpu"):
    gen = torch.Generator().manual_seed(seed)
    b, c = shape[:2]
    return torch.randn((b, c), generator=gen).to(device), (torch.randn((b, c), generator=gen) * 1e-3).to(device)


def _eager_sums(f):
    """The chain ``ops/losses.py`` ran before the kernels."""
    ff = f.float()
    return ff.sum(dim=(-2, -1)), (ff * ff).sum(dim=(-2, -1))


def _eager_stats(f):
    return losses.stats_from_sums(*_eager_sums(f), f.shape[-2] * f.shape[-1])


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("shape", CPU_SHAPES)
def test_plain_sums_and_gradient(shape, dtype, layout):
    f = _tap(shape, dtype, layout)
    s1, s2 = ss.style_sums_fwd(f)
    assert s1.dtype == s2.dtype == torch.float32 and s1.shape == s2.shape == shape[:2]
    for s, square in ((s1, False), (s2, True)):
        ok, worst = ss.sums_within_tolerance(s, f, square)
        assert ok, f"plain {'s2' if square else 's1'} off float64 by {worst:.3g} of sum|terms|"
    g1, g2 = _cotangents(shape)
    leaf = f.detach().requires_grad_(True)
    e1, e2 = _eager_sums(leaf)
    (want,) = torch.autograd.grad((e1 * g1).sum() + (e2 * g2).sum(), leaf)
    got = ss.style_sums_bwd_plain(f, g1, g2)
    assert got.dtype == dtype and torch.equal(got, want)
    leaf = f.detach().requires_grad_(True)
    k1, k2 = ss.style_sums(leaf)
    assert torch.equal(k1, s1) and torch.equal(k2, s2)
    (through,) = torch.autograd.grad((k1 * g1).sum() + (k2 * g2).sum(), leaf)
    assert torch.equal(through, want)


CALLERS = ["style_stats", "style_loss_bn", "Classifier2.features"]


def _loss(caller, feats, targets, eager):
    stats = _eager_stats if eager else losses.style_stats
    if caller == "style_stats":
        return sum((m * 0.5 + s * 0.25).sum() for m, s in (stats(f) for f in feats))
    if caller == "style_loss_bn":
        if eager:
            return losses.style_loss_bn_stats([stats(f) for f in feats], targets)
        return losses.style_loss_bn(feats, targets)
    if eager:
        parts = [torch.cat(stats(f), dim=1) for f in feats]
        return torch.cat(parts, dim=1).square().sum()
    return Classifier2.features(feats).square().sum()


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("caller", CALLERS)
def test_callers_match_the_eager_chain(caller, dtype):
    shapes = [(2, 64, 32, 32), (2, 128, 16, 16), (2, 256, 8, 8), (2, 512, 4, 4)]
    feats = [_tap(s, dtype, "nhwc" if i % 2 == 0 else "nchw", seed=i) for i, s in enumerate(shapes)]
    targets = [_eager_stats(_tap(s, dtype, "nhwc", seed=10 + i)) for i, s in enumerate(shapes)]
    results = []
    for eager in (True, False):
        leaves = [f.detach().requires_grad_(True) for f in feats]
        loss = _loss(caller, leaves, targets, eager)
        results.append((loss.detach(), torch.autograd.grad(loss, leaves)))
    (l0, g0), (l1, g1) = results
    assert torch.equal(l0, l1)
    for a, b in zip(g0, g1):
        assert a.dtype == dtype and torch.equal(a, b)


@pytest.mark.parametrize("used", ["s1", "s2"])
def test_an_unused_output_counts_as_zero(used):
    f = _tap((2, 16, 9, 7), torch.bfloat16, "nhwc")
    g1, g2 = _cotangents(f.shape)
    grads = []
    for fn in (_eager_sums, ss.style_sums):
        leaf = f.detach().requires_grad_(True)
        s1, s2 = fn(leaf)
        loss = (s1 * g1).sum() if used == "s1" else (s2 * g2).sum()
        grads.append(torch.autograd.grad(loss, leaf)[0])
    assert torch.equal(grads[0], grads[1])


def test_cpu_path_launches_nothing_and_no_grad_saves_nothing():
    before = dict(ss.LAUNCHES)
    f = _tap((2, 8, 5, 5), torch.float32, "nchw")
    with torch.no_grad():
        s1, s2 = losses.style_stats(f)
    assert s1.grad_fn is None and ss.LAUNCHES == before


# ---------------------------------------------------------------------------
# the launch plan and the kernels' index math


def _tap_shapes():
    out = []
    for b in (1, 2, 8, 64, 128):
        for c, h in ((64, 224), (128, 112), (256, 56), (512, 28)):
            out.append((b, c, h, h))
    return out


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_plan_fills_the_card_at_every_tap_shape(dtype, layout):
    """Every tap shape, B from 1 to 128 and HW from 28x28 to 224x224: 16-byte
    loads, the splits cover HW with none empty, and the grid fills 132 SMs
    wherever the tap holds a block's worth of loads for each."""
    for shape in _tap_shapes():
        b, c, h, w = shape
        hw = h * w
        pl = ss.plan(shape, dtype, layout)
        assert pl.vec == 16 // torch.empty((), dtype=dtype).element_size()
        assert (pl.splits - 1) * pl.chunk < hw <= pl.splits * pl.chunk
        loads = b * c * hw // pl.vec
        assert pl.blocks >= min(132, loads // ss.THREADS), (shape, pl)
        assert pl.blocks <= 2 * ss.TARGET_BLOCKS or pl.splits == 1, (shape, pl)
        if layout == "nchw":
            assert pl.chunk % pl.vec == 0
        else:
            assert 1 <= pl.cg <= ss.THREADS


def _emulate(shape, pl):
    """Per element of a (B, C, H, W) tap, how often the kernels' index math
    (``ops/csrc/style_sums.cu``) reads it, and into which (b, c) partial;
    the memory offsets follow ``pl.layout``."""
    b_, c_, h, w = shape
    hw = h * w
    count = np.zeros(b_ * c_ * hw, dtype=np.int64)
    owner = np.full(b_ * c_ * hw, -1, dtype=np.int64)
    vec, T = pl.vec, ss.THREADS
    if pl.layout == "nhwc":
        ct = pl.cg * vec
        ctiles = -(-c_ // ct)
        lanes = T // pl.cg
        for k in range(pl.blocks):
            split, rest = k % pl.splits, k // pl.splits
            b, c0 = rest // ctiles, (rest % ctiles) * ct
            for t in range(T):
                g, p = t % pl.cg, t // pl.cg
                c = c0 + g * vec
                if p >= lanes or c >= c_:
                    continue
                lo, hi = split * pl.chunk, min(split * pl.chunk + pl.chunk, hw)
                for pix in range(lo + p, hi, lanes):
                    off = (b * hw + pix) * c_ + c + np.arange(vec)
                    count[off] += 1
                    owner[off] = b * c_ + c + np.arange(vec)
    else:
        for k in range(pl.blocks):
            split = k % pl.splits
            for warp in range(ss.WARPS):
                plane = (k // pl.splits) * ss.WARPS + warp
                if plane >= b_ * c_:
                    continue
                lo, hi = split * pl.chunk, min(split * pl.chunk + pl.chunk, hw)
                for lane in range(32):
                    for e in range(lo + lane * vec, hi, 32 * vec):
                        off = plane * hw + e + np.arange(vec)
                        count[off] += 1
                        owner[off] = plane
    return count, owner


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("shape,dtype,aligned", [
    ((2, 64, 12, 10), torch.bfloat16, True),
    ((1, 512, 3, 5), torch.bfloat16, True),
    ((3, 12, 7, 9), torch.bfloat16, True),  # C and HW off 8: one element a load
    ((2, 40, 8, 8), torch.float32, True),
    ((2, 64, 8, 8), torch.bfloat16, False),  # off 16-byte alignment
    ((1, 3000, 2, 2), torch.bfloat16, True),  # more channels than one block's tile
])
def test_kernel_index_math_reads_every_element_once(shape, dtype, aligned, layout):
    pl = ss.plan(shape, dtype, layout, aligned)
    count, owner = _emulate(shape, pl)
    assert (count == 1).all(), f"{pl}: elements read {np.unique(count)} times"
    b, c, h, w = shape
    if layout == "nhwc":  # element (b, pix, c) belongs to partial (b, c)
        idx = np.arange(b * h * w * c)
        want = (idx // (h * w * c)) * c + idx % c
    else:
        want = np.arange(b * c * h * w) // (h * w)
    assert (owner == want).all()
    if not aligned:
        assert pl.vec == 1


def test_kernel_input_follows_the_strides():
    before = dict(ss.COPIES)
    nhwc = _tap((2, 64, 6, 6), torch.bfloat16, "nhwc")
    nchw = _tap((2, 64, 6, 6), torch.bfloat16, "nchw")
    assert ss._kernel_input(nhwc)[1].layout == "nhwc" and ss._kernel_input(nchw)[1].layout == "nchw"
    assert ss.COPIES == before
    sliced = nhwc[:, :, 1:-1]  # channels_last bytes with rows cut: neither layout
    f, pl = ss._kernel_input(sliced)
    assert pl.layout == "nchw" and f.is_contiguous() and torch.equal(f, sliced)
    assert ss.COPIES["style_sums"] == before["style_sums"] + 1
    with pytest.raises(ValueError):
        ss._kernel_input(nhwc.half())
    with pytest.raises(ValueError):
        ss._kernel_input(nhwc[0])


# ---------------------------------------------------------------------------
# on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU or interpret mode)")
    return torch.device("cuda")


CARD_SHAPES = [(4, 64, 224, 224), (8, 512, 28, 28), (1, 5, 7, 9), (3, 12, 13, 11), (2, 40, 15, 17)]


@pytest.mark.cuda
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("shape", CARD_SHAPES)
def test_kernels_against_float64_and_the_plain_gradient(cuda, shape, dtype, layout):
    f = _tap(shape, dtype, layout, device=cuda)
    g1, g2 = _cotangents(shape, device=cuda)
    before = dict(ss.LAUNCHES)
    s1, s2 = ss.style_sums_fwd(f)
    again = ss.style_sums_fwd(f)
    g = ss.style_sums_bwd(f, g1, g2)
    torch.cuda.synchronize()
    assert ss.LAUNCHES == {"style_sums_fwd": before["style_sums_fwd"] + 2,
                           "style_sums_bwd": before["style_sums_bwd"] + 1}
    assert torch.equal(s1, again[0]) and torch.equal(s2, again[1])
    for s, square in ((s1, False), (s2, True)):
        ok, worst = ss.sums_within_tolerance(s, f, square)
        assert ok, f"kernel {'s2' if square else 's1'} off float64 by {worst:.3g} of sum|terms|"
    want = ss.style_sums_bwd_plain(f, g1, g2)
    assert g.dtype == dtype and g.stride() == f.stride() and torch.equal(g, want)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_kernel_gradient_against_autograd_through_the_chain(cuda, dtype, layout):
    """Given the same cotangents, the kernel's gradient is bit-exact with
    autograd through the eager float32 chain on the card, which adds the
    three terms in the plain version's order."""
    f = _tap((2, 64, 56, 56), dtype, layout, device=cuda)
    g1, g2 = _cotangents(f.shape, device=cuda)
    leaf = f.detach().requires_grad_(True)
    e1, e2 = _eager_sums(leaf)
    (chain,) = torch.autograd.grad((e1 * g1).sum() + (e2 * g2).sum(), leaf)
    leaf = f.detach().requires_grad_(True)
    k1, k2 = ss.style_sums(leaf)
    (kernel,) = torch.autograd.grad((k1 * g1).sum() + (k2 * g2).sum(), leaf)
    assert kernel.dtype == dtype and torch.equal(kernel, ss.style_sums_bwd_plain(f, g1, g2))
    assert torch.equal(kernel, chain)


@pytest.mark.cuda
def test_classic_nst_launches_the_kernels(cuda):
    """The classic BN path: 4 style taps x (style target + one a closure)
    forward, 4 x closures backward."""
    from iris_style_transfer_tpu_torch.models import VGG19
    from iris_style_transfer_tpu_torch.transfer.nst import make_nst_fn

    params = VGG19.init(torch.Generator().manual_seed(0), device="cuda")
    c, s = torch.rand(2, 3, 32, 32, device="cuda"), torch.rand(2, 3, 32, 32, device="cuda")
    before = dict(ss.LAUNCHES)
    make_nst_fn(epochs=3, compute_dtype=torch.bfloat16)(params, c, s)
    assert ss.LAUNCHES["style_sums_fwd"] == before["style_sums_fwd"] + 4 * 4
    assert ss.LAUNCHES["style_sums_bwd"] == before["style_sums_bwd"] + 4 * 3
    before = dict(ss.LAUNCHES)
    make_nst_fn(epochs=3, stats_taps=True, compute_dtype=torch.bfloat16)(params, c, s)
    assert ss.LAUNCHES == before
