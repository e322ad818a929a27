"""CPU parity of the port's blockwise Gram (the plain side of the Hopper
kernel in ``ops/csrc/gram.cu``) and its gradient against the JAX package's
``gram_matrix_pallas`` (interpret mode) and its custom VJP.

Tolerances: the Gram to rtol 1e-5 of its largest entry, the gradient to
rtol 1e-5 of its largest element (f32 sums over H*W taken in another
order; the JAX kernel accumulates HW tiles).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from iris_style_transfer_tpu.ops import pallas_gram as pg

from iris_style_transfer_tpu_torch.ops import blockwise_gram as bg
from iris_style_transfer_tpu_torch.ops import gram as tgram


def _nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def _close(got, want):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("shape,tile", [((2, 16, 16, 8), 64), ((3, 7, 9, 5), 2048), ((2, 8, 12, 130), 32)])
@pytest.mark.parametrize("batched_norm", [True, False])
def test_gram_and_gradient_match_pallas(shape, tile, batched_norm):
    """Tiled (16x16 in tiles of 64 pixels), a ragged 7x9 extent, and more
    than two 64-channel tiles; forward and VJP under a random cotangent."""
    rng = np.random.default_rng(0)
    x = np.maximum(rng.standard_normal(shape), 0).astype(np.float32)  # relu-like taps
    b, c = shape[0], shape[3]
    ct = rng.standard_normal((b, c, c)).astype(np.float32)
    fn = lambda v: pg.gram_matrix_pallas(v, tile, batched_norm, True)  # noqa: E731
    gj, pull = jax.vjp(fn, jnp.asarray(x))
    (dxj,) = pull(jnp.asarray(ct))

    xt = _nchw(x).requires_grad_(True)
    g = bg.gram_matrix(xt, batched_norm)
    (dx,) = torch.autograd.grad(g, xt, torch.from_numpy(ct))
    assert g.dtype == torch.float32 and g.shape == (b, c, c)
    _close(g.detach().numpy(), gj)
    _close(dx.permute(0, 2, 3, 1).numpy(), dxj)
    assert dx.is_contiguous(memory_format=torch.channels_last)


def test_bf16_gradient_is_cast_and_matches_autograd_through_the_plain_gram():
    rng = np.random.default_rng(1)
    x = _nchw(rng.standard_normal((2, 10, 6, 4)).astype(np.float32))
    ct = torch.from_numpy(rng.standard_normal((2, 4, 4)).astype(np.float32))
    x1 = x.clone().requires_grad_(True)
    x2 = x.clone().requires_grad_(True)
    (g1,) = torch.autograd.grad(bg.gram_matrix(x1), x1, ct)
    (g2,) = torch.autograd.grad(tgram.gram_matrix(x2), x2, ct)
    torch.testing.assert_close(g1, g2, rtol=1e-6, atol=1e-7)
    xb = x.to(torch.bfloat16).contiguous(memory_format=torch.channels_last).requires_grad_(True)
    gb = bg.gram_matrix(xb)
    (db,) = torch.autograd.grad(gb, xb, ct)
    assert gb.dtype == torch.float32 and db.dtype == torch.bfloat16
    torch.testing.assert_close(gb, tgram.gram_matrix(xb.detach()), rtol=0, atol=0)


def test_gram_rejects_other_devices_and_the_tolerance_is_relative():
    with pytest.raises(ValueError, match="device"):
        bg.gram_matrix(torch.zeros(1, 4, 6, 6, device="meta"))
    g = torch.tensor([[[4.0, 1.0], [1.0, 2.0]]])
    assert bg.within_tolerance(g + 3e-4, g)[0]
    assert not bg.within_tolerance(g + 5e-4, g)[0]
    g64 = g.double()
    assert bg.within_f64_tolerance(g64 + 3e-5, g64)[0]
    assert not bg.within_f64_tolerance(g64 + 5e-5, g64)[0]


@pytest.mark.parametrize("batched_norm", [True, False])
def test_f64_gram_is_the_plain_gram_in_float64(batched_norm):
    """The exact reference the kernel is held to on the card agrees with
    the plain f32 Gram to f32 rounding, and is symmetric."""
    rng = np.random.default_rng(2)
    x = _nchw(np.maximum(rng.standard_normal((2, 9, 7, 6)), 0).astype(np.float32))
    g64 = bg.gram_f64(x, batched_norm)
    assert g64.dtype == torch.float64 and g64.shape == (2, 6, 6) and torch.equal(g64, g64.transpose(1, 2))
    assert bg.within_f64_tolerance(tgram.gram_matrix(x, batched_norm), g64)[0]


# the Gram NST's 512-px style taps at batch 4 and the 2019 taps at batch 64,
# as (B, C, H, W); then odd shapes: C % 8 != 0, HW off the pixel steps, C
# off the tiles
TAPS_512 = ((4, 64, 512, 512), (4, 128, 256, 256), (4, 256, 128, 128), (4, 512, 64, 64))
TAPS_2019 = ((64, 64, 224, 224), (64, 128, 112, 112), (64, 256, 56, 56), (64, 512, 28, 28))
ODD = ((3, 5, 7, 9), (2, 130, 9, 7), (3, 24, 7, 9), (2, 136, 9, 7), (1, 8, 1, 1), (2, 64, 10, 13), (5, 200, 3, 3))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", TAPS_512 + TAPS_2019 + ODD)
def test_gram_plan_covers_every_tile_pair_and_pixel_once(shape, dtype):
    """Each (image, tile pair i <= j) gets its splits 0..S-1 once, in pixel
    order, tiling [0, HW) with no gap, overlap or empty split; the kernel
    follows dtype and shape; the blocks and shared memory fit the card."""
    b, c, h, w = shape
    hw = h * w
    pl = bg.plan(shape, dtype, True)
    assert pl.kernel == ("tc" if dtype == torch.bfloat16 and c % 8 == 0 else "fma")
    assert pl.tile * (pl.n_tiles - 1) < c <= pl.tile * pl.n_tiles
    assert pl.chunk % pl.step == 0 and pl.items == b * pl.pairs * pl.splits
    seen = {}
    for block, image, ti, tj, split, p0, p1 in (bg.decode(pl, k, hw) for k in range(pl.items)):
        assert 0 <= block < pl.blocks and 0 <= ti <= tj < pl.n_tiles and 0 <= image < b
        seen.setdefault((image, ti, tj), []).append((split, p0, p1))
    assert set(seen) == {(i, ti, tj) for i in range(b) for ti in range(pl.n_tiles) for tj in range(ti, pl.n_tiles)}
    for ranges in seen.values():
        assert [s for s, _, _ in ranges] == list(range(pl.splits))  # in split order, each once
        assert ranges[0][1] == 0 and ranges[-1][2] == hw
        assert all(p0 < p1 and p0 % pl.step == 0 for _, p0, p1 in ranges)
        assert all(a[2] == z[1] for a, z in zip(ranges, ranges[1:]))
    assert pl.smem <= bg.MAX_SMEM
    if pl.kernel == "tc":  # persistent: one block per SM, a ring of at least 3 stages of 32 KB
        assert pl.blocks <= bg.N_SM and pl.stages >= 3 and pl.threads == 128 * pl.wg + 32
        assert pl.stages * 2 * pl.wg * pl.step * 128 <= 192 * 1024 < pl.smem
    else:
        assert pl.blocks == pl.items <= bg.MAX_GRID_X


def test_gram_plan_takes_any_batch():
    """No batch limit: B = 70,000 is planned on both kernels (not run), and
    its last item is the last image's last tile pair and split."""
    for shape in ((70_000, 64, 8, 8), (70_000, 512, 4, 4), (70_000, 130, 5, 5)):
        for dtype in (torch.bfloat16, torch.float32):
            pl = bg.plan(shape, dtype, True)
            assert pl.items == shape[0] * pl.pairs * pl.splits and pl.blocks <= bg.MAX_GRID_X
            _, image, ti, tj, split, _, p1 = bg.decode(pl, pl.items - 1, shape[2] * shape[3])
            assert (image, ti, tj, split, p1) == (shape[0] - 1, pl.n_tiles - 1, pl.n_tiles - 1, pl.splits - 1,
                                                  shape[2] * shape[3])


def test_gram_plan_takes_the_cuda_cores_where_tma_cannot_read():
    """bf16 with C % 8 != 0 (rows not 16-byte multiples) or an unaligned x
    plans the CUDA-core kernel; one split of the tensor-core kernel writes G
    itself (no partials)."""
    assert bg.plan((2, 130, 9, 7), torch.bfloat16, True).kernel == "fma"
    assert bg.plan((2, 64, 9, 7), torch.bfloat16, False).kernel == "fma"
    assert bg.plan((2, 64, 9, 7), torch.bfloat16, True).kernel == "tc"
    assert bg.plan((64, 512, 28, 28), torch.bfloat16, True).splits == 1
