"""Fused depthwise conv + eval batchnorm + SiLU, stride 1, forward only.

Replaces the JAX package's TPU kernel ``ops/pallas_depthwise.py:
dw_conv_bn_silu`` with the hand-written Hopper kernel in
``ops/csrc/depthwise.cu``:

    y = silu(a * dwconv_kxk(x, w) + b),   k in {3, 5}, stride 1,

with symmetric zero padding of ``(k - 1) / 2``, f32 accumulation and an f32
epilogue, and the output in ``x.dtype``.  ``a`` and ``b`` are the eval
batchnorm folded to a per-channel affine in f32.  The JAX package ships the
TPU kernel OFF because Mosaic's (8, 128) tiling rejects every B7 shape; the
Hopper kernel has no such rule, so in the port every stride-1 MBConv
depthwise of ``models/efficientnet.py`` goes through it.

Tensors are NCHW-shaped with channels_last memory (NHWC bytes).  The
weight is the port's OIHW depthwise ``(C, 1, k, k)``; the wrapper hands the
kernel a contiguous ``(k, k, C)`` copy in ``x.dtype``, as the TPU kernel
casts its weight.  Dispatch follows the tensor's device: a CUDA tensor
launches the kernel (or raises), a CPU tensor takes the plain torch
version.  Every caller runs B7 frozen, so there is no backward; an input
that requires grad under grad mode raises rather than silently getting
none.

Kernel vs plain on the card cannot be bit-exact: the kernel contracts each
tap into an FMA and its SiLU uses ``expf``.  The stated tolerance
(:func:`within_tolerance`): float32 ``max|y_k - y_p| <= 1e-5 * max|y_p|``;
bfloat16 every element within one bf16 ulp of the larger magnitude or
within ``1e-5 * max|y_p|`` (where ``a * acc + b`` cancels to near zero, the
f32 rounding of the two forms is many ulps of the tiny result), and
>= 99.9% of elements equal.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .cuda_build import load_library

SOURCE = "depthwise.cu"
# launches of the kernel in this process; the wrapper adds one per launch
# and nothing else touches it except callers resetting it
LAUNCHES = {"dw_conv_bn_silu": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_KS = (3, 5)
_THREADS = 256  # the kernel's block size; a row of W*C elements is split into chunks of it
_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = load_library(SOURCE)
        i64, vp = ctypes.c_int64, ctypes.c_void_p
        lib.dw_conv_bn_silu.argtypes = [vp, vp, vp, vp, vp, i64, i64, i64, i64, ctypes.c_int,
                                        ctypes.c_int, vp]
        lib.dw_conv_bn_silu.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check_input(x: torch.Tensor, w: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                 k: int) -> tuple[int, int, int, int]:
    if k not in _KS:
        raise ValueError(f"dw_conv_bn_silu: k must be 3 or 5, got {k}")
    if x.dim() != 4:
        raise ValueError(f"dw_conv_bn_silu: expected an NCHW tensor, got shape {tuple(x.shape)}")
    bsz, c, h, wd = x.shape
    if tuple(w.shape) != (c, 1, k, k):
        raise ValueError(f"dw_conv_bn_silu: expected weight shape {(c, 1, k, k)}, got {tuple(w.shape)}")
    for name, t in (("a", a), ("b", b)):
        if tuple(t.shape) != (c,) or t.dtype != torch.float32:
            raise ValueError(f"dw_conv_bn_silu: {name} must be float32 of shape ({c},), "
                             f"got {t.dtype} {tuple(t.shape)}")
    if torch.is_grad_enabled() and x.requires_grad:
        raise RuntimeError("dw_conv_bn_silu is forward-only (B7 runs frozen); call it under "
                           "torch.no_grad() or on a tensor that does not require grad")
    return bsz, c, h, wd


def _kernel_fwd(x: torch.Tensor, w: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                k: int) -> torch.Tensor:
    bsz, c, h, wd = _check_input(x, w, a, b, k)
    if not x.is_cuda:
        raise ValueError(f"dw_conv_bn_silu: expected a CUDA tensor, got {x.device}")
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"dw_conv_bn_silu: expected dtype float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"dw_conv_bn_silu: expected channels_last (NHWC) memory, got strides {x.stride()}")
    for name, t in (("w", w), ("a", a), ("b", b)):
        if t.device != x.device:
            raise ValueError(f"dw_conv_bn_silu: {name} is on {t.device}, x on {x.device}")
    if -(-wd * c // _THREADS) > 65535 or bsz * h >= 2**31:
        raise ValueError(f"dw_conv_bn_silu: shape {tuple(x.shape)} exceeds the kernel's grid")
    wt = w.to(x.dtype)[:, 0].permute(1, 2, 0).contiguous()  # (k, k, C)
    a, b = a.contiguous(), b.contiguous()
    y = torch.empty_like(x, memory_format=torch.channels_last)
    lib = _library()
    with torch.cuda.device(x.device):
        err = lib.dw_conv_bn_silu(
            x.data_ptr(), wt.data_ptr(), a.data_ptr(), b.data_ptr(), y.data_ptr(),
            bsz, h, wd, c, k, _DTYPE_CODE[x.dtype], torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err:
        raise RuntimeError(f"dw_conv_bn_silu launch failed with CUDA error {err}")
    LAUNCHES["dw_conv_bn_silu"] += 1
    return y


def dw_conv_bn_silu_plain(x: torch.Tensor, w: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                          k: int) -> torch.Tensor:
    """Plain torch version: the explicit k^2 sum of shifted slices of the
    zero-padded input in f32, in the TPU kernel's (dy, dx) tap order, then
    ``a * acc + b``, SiLU and the cast.  Deliberately not ``F.conv2d``: on
    the card cuDNN may take TF32 for a float32 conv, a different function.
    Returns channels_last memory like the kernel."""
    bsz, c, h, wd = _check_input(x, w, a, b, k)
    p = (k - 1) // 2
    xp = F.pad(x.permute(0, 2, 3, 1), (0, 0, p, p, p, p))  # (B, H+2p, W+2p, C)
    wk = w.to(x.dtype).float()[:, 0]  # (C, k, k)
    acc = torch.zeros((bsz, h, wd, c), dtype=torch.float32, device=x.device)
    for dy in range(k):
        for dx in range(k):
            acc = acc + xp[:, dy : dy + h, dx : dx + wd, :].float() * wk[:, dy, dx]
    y = acc * a + b
    y = y * torch.sigmoid(y)
    return y.to(x.dtype).permute(0, 3, 1, 2)


def dw_conv_bn_silu(x: torch.Tensor, w: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                    k: int) -> torch.Tensor:
    """``silu(a * dwconv_kxk(x, w) + b)``: the kernel for a CUDA tensor, the
    plain version for a CPU tensor."""
    if x.device.type == "cuda":
        return _kernel_fwd(x, w, a, b, k)
    if x.device.type == "cpu":
        return dw_conv_bn_silu_plain(x, w, a, b, k)
    raise ValueError(f"dw_conv_bn_silu: unsupported device {x.device}")


def within_tolerance(y_kernel: torch.Tensor, y_plain: torch.Tensor) -> tuple[bool, float]:
    """The kernel-vs-plain bound stated in the module docstring; returns
    ``(ok, max_abs_err)``."""
    yk, yp = y_kernel.float(), y_plain.float()
    err = (yk - yp).abs()
    max_err = err.max().item() if err.numel() else 0.0
    if y_plain.dtype == torch.float32:
        return max_err <= 1e-5 * yp.abs().max().item(), max_err
    # one bf16 ulp at the larger magnitude, 2^(floor(log2|v|) - 7), with
    # the float32 bound as a floor for results that cancel to near zero
    mag = torch.maximum(yk.abs(), yp.abs()).clamp_min(torch.finfo(torch.bfloat16).tiny)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    within_ulp = bool((err <= torch.clamp_min(ulp, 1e-5 * yp.abs().max().item())).all())
    equal_share = (err == 0).float().mean().item() if err.numel() else 1.0
    return within_ulp and equal_share >= 0.999, max_err
