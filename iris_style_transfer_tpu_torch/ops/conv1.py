"""3x3 stride-1 pad-1 convolution for a tiny input depth, plus bias:
VGG19's conv1_1 (3 -> 64).

Replaces the JAX package's TPU kernel ``ops/pallas_conv1.py:conv1_fwd``
with the hand-written Hopper kernel in ``ops/csrc/conv1.cu``:

    y[b, o, i, j] = bias[o] + sum_{kh, kw, ci} xpad[b, ci, i+kh, j+kw] * w[o, ci, kh, kw]

for C_in from 1 to 4 and C_out up to 128, float32 or bfloat16 in and out,
f32 accumulation in a fixed order, the bias added in f32, one rounding to
the output dtype.  The JAX package runs conv1_1 through
``models/layers.py:conv2d_mxu_dx`` (an XLA forward with a custom input
gradient); its Pallas forward has no caller there.  The TPU kernel's
``supported()`` shape gate is a TPU tiling rule and is not carried over:
the Hopper kernel takes any B, H and W.

Tensors are NCHW-shaped with channels_last memory (NHWC bytes), as
``models/vgg.py`` stages the image.  The weight is OIHW; the wrapper rounds
it to the input's dtype (as the plain version does) and hands the kernel an
f32 HWIO copy and an f32 bias.  Dispatch follows the tensor's device: a
CUDA tensor launches the kernel (or raises), a CPU tensor takes the plain
version.

:class:`Conv1`'s backward is the library convolution backward with the
output mask taken from ``ctx.needs_input_grad``: the NST closures ask for
dx only, training conv1_1 for dw and db only.  The JAX package computes the
same gradient outside any Pallas kernel (``_conv_small_cin_bwd``).

The plain version rounds as the kernel does: an f32 conv of the inputs
rounded to the input dtype, then one rounding.  (On an H100, cuDNN's bf16
conv with a bf16 bias rounds before and after the bias add and matched the
kernel on only 63% of elements, each within one ulp; the bf16 products are
exact in f32 and in TF32.)  Kernel vs plain on the card
(:func:`within_tolerance`): float32 ``max|y_k - y_p| <= 1e-5 * max|y_p|``
(with TF32 off for the plain conv);
bfloat16 every element within one bf16 ulp of the larger magnitude, or
within ``1e-5 * max|y_p|`` where the sum cancels to near zero, and >= 99.9%
of elements equal.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .cuda_build import load_library

SOURCE = "conv1.cu"
# launches of the kernel in this process; the wrapper adds one per launch
# and nothing else touches it except callers resetting it
LAUNCHES = {"conv1": 0}

MAX_CIN = 4
MAX_COUT = 128
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = load_library(SOURCE)
        i64, vp, i32 = ctypes.c_int64, ctypes.c_void_p, ctypes.c_int
        lib.conv1_fwd.argtypes = [vp, vp, vp, vp, i64, i64, i64, i32, i32, i32, vp]
        lib.conv1_fwd.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check_input(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> tuple[int, int, int, int, int]:
    if x.dim() != 4:
        raise ValueError(f"conv1: expected an NCHW tensor, got shape {tuple(x.shape)}")
    bsz, cin, h, wd = x.shape
    if not 1 <= cin <= MAX_CIN:
        raise ValueError(f"conv1: C_in must be 1..{MAX_CIN}, got {cin}")
    cout = w.shape[0]
    if w.dim() != 4 or tuple(w.shape[1:]) != (cin, 3, 3) or not 1 <= cout <= MAX_COUT:
        raise ValueError(f"conv1: expected an OIHW weight (C_out <= {MAX_COUT}, {cin}, 3, 3), "
                         f"got {tuple(w.shape)}")
    if tuple(b.shape) != (cout,):
        raise ValueError(f"conv1: expected a bias of shape ({cout},), got {tuple(b.shape)}")
    return bsz, cin, h, wd, cout


def _kernel_fwd(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    bsz, cin, h, wd, cout = _check_input(x, w, b)
    if not x.is_cuda or w.device != x.device or b.device != x.device:
        raise ValueError(f"conv1: expected x, w and b on one CUDA device, got {x.device}, {w.device}, {b.device}")
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"conv1: expected dtype float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"conv1: expected channels_last (NHWC) memory, got strides {x.stride()}")
    if bsz > 65535:
        raise ValueError(f"conv1: a batch of {bsz} exceeds the kernel's grid (65535)")
    w_hwio = w.to(x.dtype).float().permute(2, 3, 1, 0).contiguous()
    bias = b.float().contiguous()
    y = torch.empty((bsz, cout, h, wd), dtype=x.dtype, device=x.device, memory_format=torch.channels_last)
    lib = _library()
    with torch.cuda.device(x.device):
        err = lib.conv1_fwd(
            x.data_ptr(), w_hwio.data_ptr(), bias.data_ptr(), y.data_ptr(), bsz, h, wd, cin, cout,
            _DTYPE_CODE[x.dtype], torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err:
        raise RuntimeError(f"conv1_fwd launch failed with CUDA error {err}")
    LAUNCHES["conv1"] += 1
    return y


def conv1_fwd_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain torch version with the kernel's rounding: ``F.conv2d`` in f32
    on the input and the weight rounded to the input's dtype, the bias added
    in f32, one rounding to the input's dtype.  (A bf16 ``F.conv2d`` with a
    bf16 bias rounds twice, before and after the bias.)"""
    _check_input(x, w, b)
    return F.conv2d(x.float(), w.to(x.dtype).float(), b.float(), padding=1).to(x.dtype)


def conv1_fwd(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The 3x3 small-C_in conv: the kernel for a CUDA tensor, the plain
    version for a CPU tensor."""
    if x.device.type == "cuda":
        return _kernel_fwd(x, w, b)
    if x.device.type == "cpu":
        return conv1_fwd_plain(x, w, b)
    raise ValueError(f"conv1_fwd: unsupported device {x.device}")


class Conv1(torch.autograd.Function):
    """:func:`conv1_fwd` with the library convolution backward, computing
    only the gradients autograd asks for."""

    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w)
        ctx.b_dtype = b.dtype
        return conv1_fwd(x, w, b)

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        wc = w.to(x.dtype)
        gx, gw, gb = torch.ops.aten.convolution_backward(
            gy.to(x.dtype), x, wc, [wc.shape[0]], [1, 1], [1, 1], [1, 1], False, [0, 0], 1,
            list(ctx.needs_input_grad),
        )
        return (gx, None if gw is None else gw.to(w.dtype), None if gb is None else gb.to(ctx.b_dtype))


def conv1(x: torch.Tensor, p: dict) -> torch.Tensor:
    """conv1_1 of ``models/vgg.py``: ``p`` holds the OIHW weight ``w`` and
    the bias ``b``."""
    return Conv1.apply(x, p["w"], p["b"])


def within_tolerance(y_kernel: torch.Tensor, y_plain: torch.Tensor) -> tuple[bool, float]:
    """The kernel-vs-plain bound stated in the module docstring; returns
    ``(ok, max_abs_err)``."""
    yk, yp = y_kernel.float(), y_plain.float()
    err = (yk - yp).abs()
    max_err = err.max().item() if err.numel() else 0.0
    scale = yp.abs().max().item() if yp.numel() else 0.0
    if y_plain.dtype == torch.float32:
        return max_err <= 1e-5 * scale, max_err
    # one bf16 ulp at the larger magnitude, 2^(floor(log2|v|) - 7), with the
    # float32 bound as a floor for sums that cancel to near zero
    mag = torch.maximum(yk.abs(), yp.abs()).clamp_min(torch.finfo(torch.bfloat16).tiny)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    within_ulp = bool((err <= torch.clamp_min(ulp, 1e-5 * scale)).all())
    equal_share = (err == 0).float().mean().item() if err.numel() else 1.0
    return within_ulp and equal_share >= 0.999, max_err
