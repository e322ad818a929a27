"""CPU parity of the port's fused relu+stats op (the plain side of the
Hopper kernels in ``ops/csrc/relu_stats.cu``) against the JAX package.

Tolerances: ``y`` equals the Pallas interpret-mode kernel and the
``layers.relu_stats`` VJP bit for bit, and so does the gradient against the
VJP (the same f32 expression in the same order, one cast).  The Pallas
backward in interpret mode contracts ``a + 2x * b2`` into an FMA, so its
gradient is held to one rounding of that: ``|g - g_j| <= 2^-22 * (|ct_y| +
|a| + |2x b2|) + eps * |g_j|`` (eps one ulp of the dtype), with >= 99.9%
of elements equal in bfloat16 (80% in float32).  ``s1``/``s2`` agree to
rtol 1e-6 (f32 sums taken in another order).  The shapes are NHWC on the JAX side and NCHW
views of the same bytes on the torch side.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from iris_style_transfer_tpu.models import layers as jl
from iris_style_transfer_tpu.ops import pallas_relu_stats as prs

from iris_style_transfer_tpu_torch.models import layers as tl
from iris_style_transfer_tpu_torch.ops import relu_stats as rs


def _nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).float().numpy()


def _inputs(shape, seed, dtype):
    """x with planted zeros and negatives, and the three cotangents, all
    exactly representable in ``dtype``."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    x[:, 0, 0, :] = 0.0
    x[:, -1, :, 0] = -np.abs(x[:, -1, :, 0]) - 0.25  # an all-negative row of channel 0
    x = torch.from_numpy(x).to(dtype).float().numpy()
    ct_y = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype).float().numpy()
    b, c = shape[0], shape[3]
    return x, ct_y, rng.standard_normal((b, c)).astype(np.float32), rng.standard_normal((b, c)).astype(np.float32)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_plain_matches_pallas_interpret(dtype):
    """The Pallas lane-full kernels need B*C a multiple of 128: (4,16,16,32)."""
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    x, ct_y, a, b2 = _inputs((4, 16, 16, 32), 0, tdt)
    xj = jnp.asarray(x).astype(jdt)
    yj, s1j, s2j = prs.relu_stats_fwd(xj, interpret=True)
    gj = prs.relu_stats_bwd(xj, jnp.asarray(ct_y).astype(jdt), jnp.asarray(a), jnp.asarray(b2), interpret=True)

    xt = _nchw(x).to(tdt)
    y, s1, s2 = rs.relu_stats_fwd(xt)
    g = rs.relu_stats_bwd(xt, _nchw(ct_y).to(tdt), torch.from_numpy(a), torch.from_numpy(b2))
    assert y.dtype == tdt and g.dtype == tdt and s1.dtype == torch.float32
    assert y.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_array_equal(_nhwc(y), np.asarray(yj.astype(jnp.float32)))
    g, gj = _nhwc(g), np.asarray(gj.astype(jnp.float32))
    terms = np.abs(ct_y) + np.abs(a)[:, None, None, :] + np.abs(2 * x * b2[:, None, None, :])
    eps = 2.0**-7 if dtype == "bfloat16" else 2.0**-23
    assert np.all(np.abs(g - gj) <= 2.0**-22 * terms + eps * np.abs(gj))
    assert np.mean(g == gj) >= (0.999 if dtype == "bfloat16" else 0.8)
    np.testing.assert_allclose(s1.numpy(), np.asarray(s1j), rtol=1e-6)
    np.testing.assert_allclose(s2.numpy(), np.asarray(s2j), rtol=1e-6)


@pytest.mark.parametrize("shape", [(2, 8, 8, 4), (3, 5, 7, 9)])
def test_autograd_matches_layers_relu_stats_vjp(shape):
    """Value and gradient of a loss on all three outputs against JAX's
    ``layers.relu_stats`` (its XLA path on the CPU), in float32."""
    x, ct_y, a, b2 = _inputs(shape, 1, torch.float32)
    (yj, s1j, s2j), pull = jax.vjp(jl.relu_stats, jnp.asarray(x))
    (gj,) = pull((jnp.asarray(ct_y), jnp.asarray(a), jnp.asarray(b2)))

    xt = _nchw(x).requires_grad_(True)
    y, s1, s2 = tl.relu_stats(xt)
    (g,) = torch.autograd.grad((y, s1, s2), xt, (_nchw(ct_y), torch.from_numpy(a), torch.from_numpy(b2)))
    np.testing.assert_array_equal(_nhwc(y.detach()), np.asarray(yj))
    np.testing.assert_allclose(s1.detach().numpy(), np.asarray(s1j), rtol=1e-6)
    np.testing.assert_allclose(s2.detach().numpy(), np.asarray(s2j), rtol=1e-6)
    np.testing.assert_array_equal(_nhwc(g), np.asarray(gj))
    assert g.is_contiguous(memory_format=torch.channels_last)


def test_unused_outputs_arrive_as_zeros():
    """A loss on s2 alone: the Function's backward gets zeros for y and s1
    and the gradient equals autograd through relu and the sum of squares."""
    x, _, _, _ = _inputs((2, 6, 5, 3), 2, torch.float32)
    x1 = _nchw(x).requires_grad_(True)
    x2 = _nchw(x).requires_grad_(True)
    (g1,) = torch.autograd.grad(rs.relu_stats(x1)[2].sum(), x1)
    (g2,) = torch.autograd.grad(torch.relu(x2).square().sum(dim=(2, 3)).sum(), x2)
    torch.testing.assert_close(g1, g2, rtol=0, atol=0)


def test_rejects_other_devices():
    with pytest.raises(ValueError, match="device"):
        rs.relu_stats_fwd(torch.zeros(1, 4, 6, 6, device="meta"))
    with pytest.raises(ValueError, match="NCHW"):
        rs.relu_stats_fwd(torch.zeros(4, 6, 6))


def test_sums_tolerance_is_relative_to_the_sum():
    s = torch.tensor([[100.0, 0.0]])
    assert rs.sums_within_tolerance(s + torch.tensor([[5e-4, 0.0]]), s)[0]
    assert not rs.sums_within_tolerance(s + torch.tensor([[2e-3, 0.0]]), s)[0]
    assert not rs.sums_within_tolerance(s + torch.tensor([[0.0, 1e-9]]), s)[0]


@pytest.mark.parametrize("shape", [(3, 5, 7, 9), (2, 300, 7, 9), (1, 1, 1, 1), (4, 64, 16, 16), (2, 512, 3, 5)])
def test_plan_covers_every_element_once(shape):
    """Both grids as the kernels decode them: the forward's blocks hit each
    (image, channel, pixel) once through (split, channel tile, lane, pixel
    lane), the backward's each element once."""
    b, c, h, w = shape
    hw = h * w
    pl = rs.plan(shape)
    lanes = 256 // pl.ct
    fwd = []
    for k in range(pl.fwd_blocks):
        split, rest = k % pl.splits, k // pl.splits
        ctile, image = rest % pl.ctiles, rest // pl.ctiles
        for lane in range(pl.ct):
            ch = ctile * pl.ct + lane
            if ch < c:
                for p in range(lanes):
                    fwd += [(image, ch, px) for px in range(split * pl.chunk + p, min((split + 1) * pl.chunk, hw), lanes)]
    assert sorted(fwd) == [(i, ch, px) for i in range(b) for ch in range(c) for px in range(hw)]
    bwd = [(z * pl.img_rows + y, x * 256 + t) for x in range(pl.per_img) for y in range(pl.img_rows)
           for z in range(-(-b // pl.img_rows)) for t in range(256) if z * pl.img_rows + y < b]
    assert sorted(e for e in bwd if e[1] < hw * c) == [(i, e) for i in range(b) for e in range(hw * c)]


def test_plan_takes_any_batch_and_large_images():
    """No batch limit and no 2^31 limit on an image's elements: B = 70,000
    and an 8192 x 8192 x 64 image are planned (not run); only a grid past
    2^31 - 1 blocks raises, with the reason."""
    pl = rs.plan((70_000, 64, 224, 224))
    assert pl.fwd_blocks == 70_000 * pl.splits * pl.ctiles < 2**31
    assert pl.img_rows == 65_535 and pl.per_img * 256 == 224 * 224 * 64  # images 65,535.. take grid.z = 1
    assert rs.plan((1, 64, 8192, 8192)).per_img * 256 >= 2**31
    for shape in ((2**31, 8, 1, 1), (1, 512, 2**20, 2**20)):  # the forward's blocks; one image's
        with pytest.raises(ValueError, match="2\\^31 - 1"):
            rs.plan(shape)
