"""The hand-written CUDA kernels against their plain torch versions.

These need an NVIDIA GPU and nvcc; without CUDA they skip.  On the card:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

This file imports no JAX (``--noconftest`` skips the JAX set-up of
``tests/conftest.py``), so it runs where only the port is installed.
"""

import pytest
import torch

from iris_style_transfer_tpu_torch.models import VGG19, EfficientNet
from iris_style_transfer_tpu_torch.ops import blockwise_gram as bg
from iris_style_transfer_tpu_torch.ops import connected as cc
from iris_style_transfer_tpu_torch.ops import conv1 as c1
from iris_style_transfer_tpu_torch.ops import depthwise as dw
from iris_style_transfer_tpu_torch.ops import relu_pool as rp
from iris_style_transfer_tpu_torch.ops import relu_stats as rs
from iris_style_transfer_tpu_torch.transfer.nst import make_nst_fn

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


def _dw_inputs(shape_nhwc, k, dtype, gen, offset=0):
    b, h, w, c = shape_nhwc
    x = torch.randn(b * h * w * c + offset, generator=gen, device="cuda").to(dtype)[offset:]
    x = x.view(shape_nhwc).permute(0, 3, 1, 2)
    wt = (torch.randn((c, 1, k, k), generator=gen, device="cuda") * 0.3).to(dtype)
    a = torch.rand(c, generator=gen, device="cuda") * 1.5 + 0.5
    bias = torch.randn(c, generator=gen, device="cuda")
    return x, wt, a, bias


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,k,offset", [
    ((2, 16, 20, 256), 3, 0), ((3, 13, 7, 40), 5, 0), ((4, 26, 40, 960), 5, 0),
    ((3, 9, 11, 36), 3, 0), ((3, 9, 11, 36), 5, 0),  # C % 8 != 0: scalar channels
    ((2, 6, 3, 64), 3, 0), ((2, 6, 3, 64), 5, 0),  # W shorter than a thread's run
    ((2, 1, 17, 40), 3, 0), ((2, 1, 17, 40), 5, 0),  # H = 1
    ((2, 9, 12, 64), 3, 1),  # x off 16-byte alignment: scalar channels
])
def test_depthwise_kernel_within_tolerance(cuda, dtype, shape, k, offset):
    x, wt, a, bias = _dw_inputs(shape, k, dtype, torch.Generator(device="cuda").manual_seed(1), offset)
    assert dw.plan(tuple(x.shape), k, x.element_size(), x.data_ptr() % 16 == 0).vec == (
        4 if shape[-1] % 8 == 0 and not offset else 1)
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
    # grad mode is not refused: the kernel's forward carries the Function's backward
    y = dw.dw_conv_bn_silu(x.requires_grad_(True), wt, a, bias, 3)
    assert y.grad_fn is not None and torch.autograd.grad(y.sum(), x)[0].shape == x.shape


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,k", [((2, 16, 20, 256), 3), ((3, 13, 7, 40), 5), ((3, 9, 11, 36), 3)])
def test_depthwise_gradient_matches_autograd_through_plain(cuda, dtype, shape, k):
    """The Function (kernel forward, plain f32 backward) against autograd
    through the plain version under one cotangent, on the same values in
    float32, cast once to each input's dtype (in bf16, autograd would sum
    the taps' dx contributions in bf16): f32 within 1e-5 of each
    gradient's largest magnitude; bf16 within 1e-2 (dx and dw are bf16,
    whose ulp is 2^-8 of the value)."""
    x, wt, a, bias = _dw_inputs(shape, k, dtype, torch.Generator(device="cuda").manual_seed(7))
    ct = torch.randn(x.shape, device="cuda").to(dtype).contiguous(memory_format=torch.channels_last)
    leaves = [t.detach().clone().requires_grad_(True) for t in (x, wt, a, bias)]
    got = torch.autograd.grad(dw.dw_conv_bn_silu(*leaves, k), leaves, ct)
    ref = [t.detach().float().requires_grad_(True) for t in (x, wt, a, bias)]
    want = torch.autograd.grad(dw.dw_conv_bn_silu_plain(*ref, k), ref, ct.float())
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    for g, t, p in zip(got, leaves, want):
        assert g.dtype == t.dtype
        err = (g.float() - p.to(g.dtype).float()).abs().max().item()
        assert err <= tol * p.abs().max().item(), err


def test_efficientnet_apply_launches_the_kernel_102_times(cuda):
    params = EfficientNet.init(torch.Generator().manual_seed(0), device="cuda")
    frames = torch.rand(1, 48, 64, 1, device="cuda")
    before = dw.LAUNCHES["dw_conv_bn_silu"]
    with torch.no_grad():
        labels = EfficientNet.apply(params, frames, compute_dtype=torch.bfloat16)
    assert labels.shape == (1, 48, 64)
    assert dw.LAUNCHES["dw_conv_bn_silu"] == before + 102  # 51 stride-1 blocks, twice for the flip


def _stats_inputs(shape_nhwc, dtype, gen):
    b, h, w, c = shape_nhwc
    x = torch.randn(shape_nhwc, generator=gen, device="cuda")
    x[:, 0:2, 0:2, :] = 0.0
    x = x.to(dtype).permute(0, 3, 1, 2)
    ct = torch.randn(shape_nhwc, generator=gen, device="cuda").to(dtype).permute(0, 3, 1, 2)
    return x, ct, torch.randn((b, c), generator=gen, device="cuda"), torch.randn((b, c), generator=gen, device="cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 8, 12, 3), (4, 32, 32, 64), (3, 7, 9, 300), (1, 1, 1, 1)])
def test_relu_stats_kernels_exact_and_within_tolerance(cuda, dtype, shape):
    x, ct, a, b2 = _stats_inputs(shape, dtype, torch.Generator(device="cuda").manual_seed(3))
    before = dict(rs.LAUNCHES)
    y, s1, s2 = rs.relu_stats_fwd(x)
    g = rs.relu_stats_bwd(x, ct, a, b2)
    assert rs.LAUNCHES["relu_stats_fwd"] == before["relu_stats_fwd"] + 1
    assert rs.LAUNCHES["relu_stats_bwd"] == before["relu_stats_bwd"] + 1
    y_p, s1_p, s2_p = rs.relu_stats_fwd_plain(x)
    assert torch.equal(y, y_p) and torch.equal(g, rs.relu_stats_bwd_plain(x, ct, a, b2))
    assert rs.sums_within_tolerance(s1, s1_p)[0] and rs.sums_within_tolerance(s2, s2_p)[0]
    assert y.is_contiguous(memory_format=torch.channels_last) and g.is_contiguous(memory_format=torch.channels_last)


def test_relu_stats_kernels_reject_other_layouts_and_dtypes(cuda):
    x, ct, a, b2 = _stats_inputs((2, 8, 8, 16), torch.float32, torch.Generator(device="cuda").manual_seed(4))
    with pytest.raises(ValueError, match="channels_last"):
        rs.relu_stats_fwd(x.contiguous())
    with pytest.raises(ValueError, match="dtype"):
        rs.relu_stats_fwd(x.half())
    with pytest.raises(ValueError, match="dtype"):
        rs.relu_stats_bwd(x, ct, a.double(), b2)
    with pytest.raises(ValueError, match="shape"):
        rs.relu_stats_bwd(x, ct, a[:, :3], b2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [
    (2, 16, 16, 64), (1, 64, 64, 256), (2, 32, 32, 128), (1, 16, 24, 512),  # C = 64, 128, 256, 512
    (3, 7, 9, 5), (2, 9, 7, 130),  # C % 8 != 0: the CUDA-core kernel in both dtypes
    (3, 7, 9, 24), (2, 9, 7, 136), (1, 1, 1, 8),  # HW off the 128-pixel step, C off the tile
])
def test_gram_kernel_within_tolerance(cuda, dtype, shape):
    x = torch.relu(torch.randn(shape, generator=torch.Generator(device="cuda").manual_seed(5), device="cuda"))
    x = x.to(dtype).permute(0, 3, 1, 2)
    pl = bg.plan(tuple(x.shape), dtype, True, bg._n_sm(0))
    assert pl.kernel == ("tc" if dtype == torch.bfloat16 and shape[-1] % 8 == 0 else "fma")
    before = bg.LAUNCHES["gram_matrix"]
    g = bg.gram_fwd(x)
    assert bg.LAUNCHES["gram_matrix"] == before + 1
    assert torch.equal(g, bg.gram_fwd(x))  # the ordered reduction repeats itself bit for bit
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        ok, err = bg.within_tolerance(g, bg.gram_matrix_plain(x))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    assert ok, err
    ok, err = bg.within_f64_tolerance(g, bg.gram_f64(x))
    assert ok, err
    assert torch.equal(g, g.transpose(1, 2))  # mirrored tiles


def test_gram_unaligned_bf16_takes_the_cuda_core_kernel(cuda):
    """TMA needs a 16-byte aligned base: an x 2 bytes into its storage is
    planned on the CUDA-core kernel and still meets both tolerances."""
    base = torch.relu(torch.randn(2 * 12 * 10 * 64 + 1, device="cuda")).to(torch.bfloat16)
    x = base[1:].view(2, 12, 10, 64).permute(0, 3, 1, 2)
    assert x.data_ptr() % 16 != 0 and bg.plan(tuple(x.shape), x.dtype, False).kernel == "fma"
    g = bg.gram_fwd(x)
    assert bg.within_tolerance(g, bg.gram_matrix_plain(x))[0] and bg.within_f64_tolerance(g, bg.gram_f64(x))[0]


def test_gram_kernel_rejects_other_layouts_and_dtypes(cuda):
    x = torch.rand(2, 4, 8, 8, device="cuda")  # NCHW-contiguous
    with pytest.raises(ValueError, match="channels_last"):
        bg.gram_fwd(x)
    with pytest.raises(ValueError, match="dtype"):
        bg.gram_fwd(x.half().contiguous(memory_format=torch.channels_last))
    assert bg.gram_matrix(x).shape == (2, 4, 4)  # the differentiable entry converts the layout


def test_nst_paths_launch_the_kernels_as_derived(cuda):
    """Stats taps: 4 x (epochs + 2) forward and 4 x epochs backward launches;
    Gram loss: 4 x (epochs + 1) Gram launches."""
    params = VGG19.init(torch.Generator().manual_seed(0), device="cuda")
    c, s = torch.rand(2, 3, 32, 32, device="cuda"), torch.rand(2, 3, 32, 32, device="cuda")
    before = dict(rs.LAUNCHES)
    make_nst_fn(epochs=3, stats_taps=True, compute_dtype=torch.bfloat16)(params, c, s)
    assert rs.LAUNCHES["relu_stats_fwd"] == before["relu_stats_fwd"] + 4 * 5
    assert rs.LAUNCHES["relu_stats_bwd"] == before["relu_stats_bwd"] + 4 * 3
    before = bg.LAUNCHES["gram_matrix"]
    make_nst_fn(epochs=3, bn_loss=False, compute_dtype=torch.bfloat16)(params, c, s)
    assert bg.LAUNCHES["gram_matrix"] == before + 4 * 4


@pytest.mark.parametrize("shape,cout,dtype", [
    ((2, 3, 37, 53), 64, torch.float32), ((4, 3, 64, 96), 64, torch.bfloat16),
    ((2, 1, 9, 11), 20, torch.float32), ((2, 4, 33, 17), 128, torch.bfloat16),
    ((3, 1, 13, 29), 64, torch.bfloat16), ((3, 4, 13, 29), 64, torch.bfloat16),  # C_in 1 and 4
    ((2, 3, 17, 45), 60, torch.bfloat16), ((2, 3, 17, 45), 60, torch.float32),  # C_out 60; H, W off the tile
    ((2, 2, 9, 70), 128, torch.bfloat16),  # two chunks of 64 output channels
])
def test_conv1_kernel_within_tolerance(cuda, shape, cout, dtype):
    gen = torch.Generator(device="cuda").manual_seed(6)
    b, cin, h, w = shape
    x = torch.rand((b, h, w, cin), generator=gen, device="cuda").to(dtype).permute(0, 3, 1, 2)
    wt = torch.randn((cout, cin, 3, 3), generator=gen, device="cuda") * 0.3
    bias = torch.randn(cout, generator=gen, device="cuda")
    before = c1.LAUNCHES["conv1"]
    y = c1.conv1_fwd(x, wt, bias)
    torch.cuda.synchronize()
    assert c1.LAUNCHES["conv1"] == before + 1
    assert y.dtype == dtype and y.is_contiguous(memory_format=torch.channels_last)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        ok, err = c1.within_tolerance(y, c1.conv1_fwd_plain(x, wt, bias))
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    assert ok, err


def test_conv1_kernel_rejects_other_layouts(cuda):
    x = torch.rand(2, 3, 8, 8, device="cuda")  # NCHW-contiguous
    wt, bias = torch.randn(8, 3, 3, 3, device="cuda"), torch.zeros(8, device="cuda")
    with pytest.raises(ValueError, match="channels_last"):
        c1.conv1_fwd(x, wt, bias)
    with pytest.raises(ValueError, match="dtype"):
        c1.conv1_fwd(x.half().contiguous(memory_format=torch.channels_last), wt, bias)


def test_vgg19_conv1_1_goes_through_the_kernel(cuda):
    params = VGG19.init(torch.Generator().manual_seed(0), device="cuda")
    x = torch.rand(2, 3, 32, 32, device="cuda", requires_grad=True)
    before = c1.LAUNCHES["conv1"]
    _, c, s = VGG19.apply(params, x, compute_dtype=torch.bfloat16, truncate=True)
    torch.autograd.grad(sum(f.float().sum() for f in [*c, *s]), x)
    assert c1.LAUNCHES["conv1"] == before + 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_take_a_batch_past_65535(cuda, dtype):
    """The lifted grid limits, run: 70,000 tiny images through relu_stats
    (its general backward: grid.z carries the images past 65,535), the Gram
    (in bf16 its tensor-core kernel's work items, in f32 one block per item
    on a 1-D grid) and conv1 (the f32 kernel's 1-D grid)."""
    gen = torch.Generator(device="cuda").manual_seed(8)
    x, ct, a, b2 = _stats_inputs((70_000, 1, 2, 8), dtype, gen)
    y, s1, s2 = rs.relu_stats_fwd(x)
    y_p, s1_p, s2_p = rs.relu_stats_fwd_plain(x)
    assert torch.equal(y, y_p) and rs.sums_within_tolerance(s1, s1_p)[0] and rs.sums_within_tolerance(s2, s2_p)[0]
    assert torch.equal(rs.relu_stats_bwd(x, ct, a, b2), rs.relu_stats_bwd_plain(x, ct, a, b2))
    g = bg.gram_fwd(torch.relu(x))
    assert bg.within_f64_tolerance(g, bg.gram_f64(torch.relu(x)))[0]
    xc = torch.rand((70_000, 2, 3, 3), generator=gen, device="cuda").to(dtype).permute(0, 3, 1, 2)
    wt, bias = torch.randn((16, 3, 3, 3), generator=gen, device="cuda"), torch.randn(16, generator=gen, device="cuda")
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        assert c1.within_tolerance(c1.conv1_fwd(xc, wt, bias), c1.conv1_fwd_plain(xc, wt, bias))[0]
    finally:
        torch.backends.cudnn.allow_tf32 = tf32


def _serpentine(h, w):
    m = torch.zeros((h, w), dtype=torch.bool)
    m[0::2] = True
    for k, y in enumerate(range(1, h, 2)):
        m[y, w - 1 if k % 2 == 0 else 0] = True
    return m


@pytest.mark.parametrize("connectivity", [1, 2])
def test_connected_components_kernel_is_bit_exact(cuda, connectivity):
    """The union-find kernel against the plain labelling on the card:
    seeded noise at three densities, a serpentine, all-false and all-true,
    B = 1 and several; three launches a call."""
    gen = torch.Generator(device="cuda").manual_seed(8)
    masks = [torch.rand((4, 37, 53), generator=gen, device="cuda") < d for d in (0.3, 0.45, 0.6)]
    masks += [_serpentine(40, 64)[None].cuda(), torch.zeros((2, 9, 7), dtype=torch.bool, device="cuda"),
              torch.ones((3, 16, 24), dtype=torch.bool, device="cuda"), masks[1][:1]]
    for m in masks:
        before = cc.LAUNCHES["connected_components"]
        lab = cc.connected_components(m, connectivity)
        assert cc.LAUNCHES["connected_components"] == before + cc.KERNELS_PER_CALL
        assert lab.dtype == torch.int32 and lab.is_cuda
        assert torch.equal(lab, cc.connected_components_plain(m, connectivity))
    two = torch.zeros((1, 20, 24), dtype=torch.bool, device="cuda")
    two[0, 2:6, 15:19] = True
    two[0, 10:14, 3:7] = True
    assert torch.equal(cc.largest_component(two, connectivity).cpu(), cc.largest_component(two.cpu(), connectivity))
