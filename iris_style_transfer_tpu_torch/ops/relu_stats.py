"""Fused relu + per-channel (sum, sum of squares), forward and backward.

Replaces the JAX package's TPU kernel pair
``ops/pallas_relu_stats.py:relu_stats_fwd`` / ``relu_stats_bwd`` (reached
from ``models/layers.py:relu_stats``, the NST style taps under
``--stats_taps on``) with the hand-written Hopper kernels in
``ops/csrc/relu_stats.cu``:

    forward : y = relu(x);  s1 = sum_hw y;  s2 = sum_hw y*y   per (B, C), f32
    backward: g = (x > 0) * ((ct_y + ct_s1) + (2 x) * ct_s2)  in f32, cast once

Tensors are NCHW-shaped with channels_last memory (NHWC bytes), as the
VGG stack hands its style taps to it; ``s1``, ``s2`` and their cotangents are (B, C)
float32.  Dispatch follows the tensor's device: a CUDA tensor launches the
kernel (or raises), a CPU tensor takes the plain torch version beside it.
The TPU kernel's gate (B*C a multiple of 128, a VMEM-sized strip) is a
tiling rule of the TPU; the Hopper kernels take every shape.

Kernel vs plain on the card: ``y`` and ``g`` are bit-exact (the relu keeps
x's own bits; the backward rounds in the plain expression's order with no
FMA contraction).  ``s1`` and ``s2`` differ from the plain version only in
the order of the f32 sums (in bf16, y*y is exact in f32); the stated
tolerance (:func:`sums_within_tolerance`) is
``|s - s_plain| <= 1e-5 * sum|terms|`` per (b, c), and since the terms are
non-negative, ``sum|terms|`` is ``s_plain`` itself.
"""

from __future__ import annotations

import ctypes

import torch

from .cuda_build import load_library

SOURCE = "relu_stats.cu"
# launches of each kernel in this process; the wrappers below add one per
# launch and nothing else touches them except callers resetting them
LAUNCHES = {"relu_stats_fwd": 0, "relu_stats_bwd": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_THREADS = 256  # the kernels' block size
_TARGET_BLOCKS = 2048  # forward blocks to aim for: ~16 per SM on 132 SMs
_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = load_library(SOURCE)
        i64, vp = ctypes.c_int64, ctypes.c_void_p
        lib.relu_stats_fwd.argtypes = [vp, vp, vp, vp, vp, vp, i64, i64, i64, i64, ctypes.c_int, vp]
        lib.relu_stats_fwd.restype = ctypes.c_int
        lib.relu_stats_bwd.argtypes = [vp, vp, vp, vp, vp, i64, i64, i64, ctypes.c_int, vp]
        lib.relu_stats_bwd.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check_input(x: torch.Tensor) -> tuple[int, int, int, int]:
    if x.dim() != 4:
        raise ValueError(f"relu_stats: expected an NCHW tensor, got shape {tuple(x.shape)}")
    return tuple(x.shape)


def _check_cuda(name: str, t: torch.Tensor, shape: tuple[int, ...], dtype: torch.dtype,
                channels_last: bool) -> None:
    if not t.is_cuda:
        raise ValueError(f"relu_stats: {name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype or (channels_last and dtype not in _DTYPE_CODE):
        raise ValueError(f"relu_stats: {name} must have dtype {dtype} (x float32 or bfloat16), "
                         f"got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"relu_stats: {name} must have shape {shape}, got {tuple(t.shape)}")
    contiguous = t.is_contiguous(memory_format=torch.channels_last) if channels_last else t.is_contiguous()
    if not contiguous:
        raise ValueError(f"relu_stats: {name} must be {'channels_last (NHWC)' if channels_last else 'contiguous'}"
                         f" memory, got strides {t.stride()}")


def _splits(b: int, c: int, hw: int) -> int:
    """HW splits of the forward: enough blocks to fill the card, at least
    one pixel row of the block's P pixel lanes per split."""
    ct = min(c, _THREADS)
    p = _THREADS // ct
    tiles = b * -(-c // ct)
    s = max(1, min(-(-_TARGET_BLOCKS // tiles), -(-hw // p), 65535))
    return -(-hw // -(-hw // s)) if hw else 1  # drop empty splits


def _kernel_fwd(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    b, c, h, w = _check_input(x)
    _check_cuda("x", x, (b, c, h, w), x.dtype, channels_last=True)
    if b > 65535:
        raise ValueError(f"relu_stats: batch {b} exceeds the kernel's grid")
    s = _splits(b, c, h * w)
    y = torch.empty_like(x, memory_format=torch.channels_last)
    # freed on return while the kernel may still run: the caching allocator
    # hands the block only to work queued later on this stream
    ws = torch.empty((2, s, b, c), dtype=torch.float32, device=x.device)
    s1 = torch.empty((b, c), dtype=torch.float32, device=x.device)
    s2 = torch.empty((b, c), dtype=torch.float32, device=x.device)
    lib = _library()
    with torch.cuda.device(x.device):
        err = lib.relu_stats_fwd(
            x.data_ptr(), y.data_ptr(), ws[0].data_ptr(), ws[1].data_ptr(), s1.data_ptr(),
            s2.data_ptr(), b, h * w, c, s, _DTYPE_CODE[x.dtype],
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err:
        raise RuntimeError(f"relu_stats_fwd launch failed with CUDA error {err}")
    LAUNCHES["relu_stats_fwd"] += 1
    return y, s1, s2


def _kernel_bwd(x: torch.Tensor, ct_y: torch.Tensor, ct_s1: torch.Tensor,
                ct_s2: torch.Tensor) -> torch.Tensor:
    b, c, h, w = _check_input(x)
    _check_cuda("x", x, (b, c, h, w), x.dtype, channels_last=True)
    _check_cuda("ct_y", ct_y, (b, c, h, w), x.dtype, channels_last=True)
    _check_cuda("ct_s1", ct_s1, (b, c), torch.float32, channels_last=False)
    _check_cuda("ct_s2", ct_s2, (b, c), torch.float32, channels_last=False)
    if h * w * c >= 2**31 or b > 65535:
        raise ValueError(f"relu_stats: shape {tuple(x.shape)} exceeds the kernel's grid")
    g = torch.empty_like(x, memory_format=torch.channels_last)
    lib = _library()
    with torch.cuda.device(x.device):
        err = lib.relu_stats_bwd(
            x.data_ptr(), ct_y.data_ptr(), ct_s1.data_ptr(), ct_s2.data_ptr(), g.data_ptr(),
            b, h * w, c, _DTYPE_CODE[x.dtype], torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err:
        raise RuntimeError(f"relu_stats_bwd launch failed with CUDA error {err}")
    LAUNCHES["relu_stats_bwd"] += 1
    return g


def relu_stats_fwd_plain(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain torch ``(relu(x), sum_hw y, sum_hw y*y)`` with f32 sums
    (``models/layers.py:relu_stats`` of the JAX package).  The relu is
    ``where(x > 0, x, 0)``, the form whose gradient mask is ``x > 0``."""
    _check_input(x)
    y = torch.where(x > 0, x, torch.zeros((), dtype=x.dtype, device=x.device))
    yf = y.float()
    return y, yf.sum(dim=(2, 3)), (yf * yf).sum(dim=(2, 3))


def relu_stats_bwd_plain(x: torch.Tensor, ct_y: torch.Tensor, ct_s1: torch.Tensor,
                         ct_s2: torch.Tensor) -> torch.Tensor:
    """Plain torch gradient (``models/layers.py:_relu_stats_bwd``):
    ``(ct_y + ct_s1) + (2 x) * ct_s2`` in f32 where ``x > 0``, else 0, cast
    once to x's dtype."""
    _check_input(x)
    a = ct_s1.float()[:, :, None, None]
    b2 = ct_s2.float()[:, :, None, None]
    g = (ct_y.float() + a) + (2.0 * x.float()) * b2
    return torch.where(x > 0, g, 0.0).to(x.dtype)


def relu_stats_fwd(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(relu(x), s1, s2)``: the kernel for a CUDA tensor, the plain
    version for a CPU tensor."""
    if x.device.type == "cuda":
        return _kernel_fwd(x)
    if x.device.type == "cpu":
        return relu_stats_fwd_plain(x)
    raise ValueError(f"relu_stats_fwd: unsupported device {x.device}")


def relu_stats_bwd(x: torch.Tensor, ct_y: torch.Tensor, ct_s1: torch.Tensor,
                   ct_s2: torch.Tensor) -> torch.Tensor:
    """Gradient of :func:`relu_stats_fwd`; dispatch as there."""
    if x.device.type == "cuda":
        return _kernel_bwd(x, ct_y, ct_s1, ct_s2)
    if x.device.type == "cpu":
        return relu_stats_bwd_plain(x, ct_y, ct_s1, ct_s2)
    raise ValueError(f"relu_stats_bwd: unsupported device {x.device}")


def sums_within_tolerance(s_kernel: torch.Tensor, s_plain: torch.Tensor) -> tuple[bool, float]:
    """The kernel-vs-plain bound on ``s1``/``s2`` stated in the module
    docstring; returns ``(ok, max_abs_err)``."""
    err = (s_kernel.double() - s_plain.double()).abs()
    max_err = err.max().item() if err.numel() else 0.0
    return bool((err <= 1e-5 * s_plain.double().abs()).all()), max_err


class ReluStats(torch.autograd.Function):
    """``(y, s1, s2) = relu_stats(x)``; saves ``x`` like the JAX VJP.  An
    output the loss does not use arrives in the backward as zeros."""

    @staticmethod
    def forward(ctx, x):
        y, s1, s2 = relu_stats_fwd(x)
        ctx.save_for_backward(x)
        return y, s1, s2

    @staticmethod
    def backward(ctx, ct_y, ct_s1, ct_s2):
        (x,) = ctx.saved_tensors
        # the kernel reads NHWC bytes; a cotangent from a channels_last conv
        # already is, and the sums' cotangents are f32 like the sums
        ct_y = ct_y.to(x.dtype).contiguous(memory_format=torch.channels_last)
        return relu_stats_bwd(x, ct_y, ct_s1.float().contiguous(), ct_s2.float().contiguous())


def relu_stats(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused relu + per-(B, C) f32 sum and sum of squares of an NCHW
    (channels_last) tensor, differentiable in all three outputs."""
    return ReluStats.apply(x)
