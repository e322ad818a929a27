"""The hand-written CUDA kernels against their plain torch versions.

These need an NVIDIA GPU and nvcc; without CUDA they skip.  On the card:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

This file imports no JAX (``--noconftest`` skips the JAX set-up of
``tests/conftest.py``), so it runs where only the port is installed.
"""

import pytest
import torch

from iris_style_transfer_tpu_torch.models import VGG19, EfficientNet
from iris_style_transfer_tpu_torch.ops import depthwise as dw
from iris_style_transfer_tpu_torch.ops import relu_pool as rp

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU or interpret mode)")
    return torch.device("cuda")


def _tied(shape_nhwc, dtype, gen):
    x = torch.round(torch.randn(shape_nhwc, generator=gen, device="cuda") * 2) / 2
    x[:, 0:2, 0:2, :] = 0.0
    x[:, 2:4, 0:2, :] = -1.5
    return x.to(dtype).permute(0, 3, 1, 2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 8, 12, 3), (8, 16, 16, 64), (1, 2, 2, 1)])
def test_relu_pool_kernel_is_bit_exact(cuda, dtype, shape):
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = _tied(shape, dtype, gen)
    b, h, w, c = shape
    ct = torch.randn((b, h // 2, w // 2, c), generator=gen, device="cuda").to(dtype).permute(0, 3, 1, 2)
    before = dict(rp.LAUNCHES)
    y = rp.relu_pool_fwd(x)
    g = rp.relu_pool_bwd(x, y, ct)
    assert rp.LAUNCHES["relu_pool_fwd"] == before["relu_pool_fwd"] + 1
    assert rp.LAUNCHES["relu_pool_bwd"] == before["relu_pool_bwd"] + 1
    assert torch.equal(y, rp.relu_pool_fwd_plain(x))
    assert torch.equal(g, rp.relu_pool_bwd_plain(x, y, ct))
    assert y.is_contiguous(memory_format=torch.channels_last)


def test_relu_pool_kernel_rejects_other_layouts(cuda):
    x = torch.randn(2, 4, 8, 8, device="cuda")  # NCHW-contiguous, C > 1
    with pytest.raises(ValueError, match="channels_last"):
        rp.relu_pool_fwd(x)
    with pytest.raises(ValueError, match="dtype"):
        rp.relu_pool_fwd(x.half().contiguous(memory_format=torch.channels_last))


def test_vgg19_pool1_goes_through_the_kernel(cuda):
    params = VGG19.init(torch.Generator().manual_seed(0), device="cuda")
    x = torch.rand(2, 3, 32, 32, device="cuda", requires_grad=True)
    before = dict(rp.LAUNCHES)
    _, c, s = VGG19.apply(params, x, compute_dtype=torch.bfloat16, truncate=True)
    torch.autograd.grad(sum(f.float().sum() for f in [*c, *s]), x)
    assert rp.LAUNCHES["relu_pool_fwd"] == before["relu_pool_fwd"] + 1
    assert rp.LAUNCHES["relu_pool_bwd"] == before["relu_pool_bwd"] + 1


def _dw_inputs(shape_nhwc, k, dtype, gen):
    b, h, w, c = shape_nhwc
    x = torch.randn(shape_nhwc, generator=gen, device="cuda").to(dtype).permute(0, 3, 1, 2)
    wt = (torch.randn((c, 1, k, k), generator=gen, device="cuda") * 0.3).to(dtype)
    a = torch.rand(c, generator=gen, device="cuda") * 1.5 + 0.5
    bias = torch.randn(c, generator=gen, device="cuda")
    return x, wt, a, bias


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,k", [((2, 16, 20, 256), 3), ((3, 13, 7, 40), 5), ((4, 26, 40, 960), 5)])
def test_depthwise_kernel_within_tolerance(cuda, dtype, shape, k):
    x, wt, a, bias = _dw_inputs(shape, k, dtype, torch.Generator(device="cuda").manual_seed(1))
    before = dw.LAUNCHES["dw_conv_bn_silu"]
    y = dw.dw_conv_bn_silu(x, wt, a, bias, k)
    torch.cuda.synchronize()
    assert dw.LAUNCHES["dw_conv_bn_silu"] == before + 1
    assert y.dtype == dtype and y.is_contiguous(memory_format=torch.channels_last)
    ok, err = dw.within_tolerance(y, dw.dw_conv_bn_silu_plain(x, wt, a, bias, k))
    assert ok, err


def test_depthwise_kernel_rejects_other_layouts(cuda):
    x, wt, a, bias = _dw_inputs((2, 8, 8, 16), 3, torch.float32, torch.Generator(device="cuda").manual_seed(2))
    with pytest.raises(ValueError, match="channels_last"):
        dw.dw_conv_bn_silu(x.contiguous(), wt, a, bias, 3)
    with pytest.raises(ValueError, match="dtype"):
        dw.dw_conv_bn_silu(x.half(), wt, a, bias, 3)
    with pytest.raises(ValueError, match="float32"):
        dw.dw_conv_bn_silu(x, wt, a.half(), bias, 3)
    with pytest.raises(RuntimeError, match="forward-only"):
        dw.dw_conv_bn_silu(x.requires_grad_(True), wt, a, bias, 3)


def test_efficientnet_apply_launches_the_kernel_102_times(cuda):
    params = EfficientNet.init(torch.Generator().manual_seed(0), device="cuda")
    frames = torch.rand(1, 48, 64, 1, device="cuda")
    before = dw.LAUNCHES["dw_conv_bn_silu"]
    with torch.no_grad():
        labels = EfficientNet.apply(params, frames, compute_dtype=torch.bfloat16)
    assert labels.shape == (1, 48, 64)
    assert dw.LAUNCHES["dw_conv_bn_silu"] == before + 102  # 51 stride-1 blocks, twice for the flip
