"""CPU parity of the port's fused depthwise op and MBConv block against JAX.

The port's ``dw_conv_bn_silu`` on a CPU tensor is its plain version; it is
held to the JAX package's Pallas kernel in interpret mode (the TPU kernel's
own CPU form) at the shapes of ``tests/test_layers.py`` plus one odd shape
(H = 13, C = 40), in float32 with rtol 1e-5 and in bfloat16 within the JAX
test's 0.05.  ``_mbconv`` is held to the JAX block with ``PALLAS_DW``
off (grouped XLA conv) in float32 with rtol 1e-4 of the output's scale.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from iris_style_transfer_tpu.models import efficientnet as jeff
from iris_style_transfer_tpu.ops import pallas_depthwise as jdw

from iris_style_transfer_tpu_torch.models import efficientnet as teff
from iris_style_transfer_tpu_torch.models.port import from_jax
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
@pytest.mark.parametrize("shape,k", [((2, 16, 20, 256), 3), ((2, 16, 20, 64), 5), ((1, 13, 7, 40), 5)])
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
    x, w, a, b = _inputs((1, 5, 6, 8), 3, seed=0)
    args = (torch.from_numpy(w).permute(3, 2, 0, 1), torch.from_numpy(a), torch.from_numpy(b), 3)
    before = dict(tdw.LAUNCHES)
    tdw.dw_conv_bn_silu(_nchw(x), *args)
    assert tdw.LAUNCHES == before
    xg = _nchw(x).requires_grad_(True)
    with pytest.raises(RuntimeError, match="forward-only"):
        tdw.dw_conv_bn_silu(xg, *args)
    with torch.no_grad():
        tdw.dw_conv_bn_silu(xg, *args)  # frozen use is fine
    with pytest.raises(ValueError, match="k must be 3 or 5"):
        tdw.dw_conv_bn_silu(_nchw(x), args[0], args[1], args[2], 7)
    with pytest.raises(ValueError, match="float32"):
        tdw.dw_conv_bn_silu(_nchw(x), args[0], args[1].double(), args[2], 3)
    with pytest.raises(ValueError, match="unsupported device"):
        tdw.dw_conv_bn_silu(_nchw(x).to("meta"), args[0], args[1], args[2], 3)


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
