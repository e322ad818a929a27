"""The hand-written CUDA kernels against their plain torch versions.

These need an NVIDIA GPU and nvcc; without CUDA they skip.  On the card:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

This file imports no JAX (``--noconftest`` skips the JAX set-up of
``tests/conftest.py``), so it runs where only the port is installed.
"""

import pytest
import torch

from iris_style_transfer_tpu_torch.models import VGG19
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
