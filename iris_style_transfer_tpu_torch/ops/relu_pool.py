"""Fused relu + 2x2 max-pool (``max_pool(relu(x), 2)``), forward and backward.

Replaces the JAX package's TPU kernel pair
``ops/pallas_pool_paired.py:relu_pool_fwd_4d`` / ``relu_pool_bwd_4d``
(reached from ``models/layers.py:relu_max_pool``) with the hand-written
Hopper kernel in ``ops/csrc/relu_pool.cu``.  The TPU's other layouts of the
same function (``ops/pallas_pool.py`` and the paired / transposed /
lane-paired views in ``ops/pallas_pool_paired.py``) exist only to fit the
TPU's tiling; this one NHWC kernel serves all of them.

Tensors are NCHW-shaped with channels_last memory (NHWC bytes), as the
VGG stack produces them.  Dispatch follows the tensor's device: a CUDA
tensor launches the kernel (or raises), a CPU tensor takes the plain torch
version beside it.  Gradient semantics are tie-to-all: every window element
that is positive and equals the window maximum receives the full cotangent
(``models/layers.py:_relu_max_pool_bwd`` of the JAX package).
"""

from __future__ import annotations

import ctypes

import torch

from .cuda_build import load_library

SOURCE = "relu_pool.cu"
# launches of each kernel in this process; the wrappers below add one per
# launch and nothing else touches them except callers resetting them
LAUNCHES = {"relu_pool_fwd": 0, "relu_pool_bwd": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = load_library(SOURCE)
        i64, vp = ctypes.c_int64, ctypes.c_void_p
        lib.relu_pool_fwd.argtypes = [vp, vp, i64, i64, i64, i64, ctypes.c_int, vp]
        lib.relu_pool_fwd.restype = ctypes.c_int
        lib.relu_pool_bwd.argtypes = [vp, vp, vp, vp, i64, i64, i64, i64, ctypes.c_int, vp]
        lib.relu_pool_bwd.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(name: str, t: torch.Tensor, shape: tuple[int, ...], dtype: torch.dtype) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype or t.dtype not in _DTYPE_CODE:
        raise ValueError(f"{name}: expected dtype {dtype} (float32 or bfloat16), got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"{name}: expected channels_last (NHWC) memory, got strides {t.stride()}")


def _check_input(x: torch.Tensor) -> tuple[int, int, int, int]:
    if x.dim() != 4:
        raise ValueError(f"relu_pool: expected an NCHW tensor, got shape {tuple(x.shape)}")
    b, c, h, w = x.shape
    if h % 2 or w % 2:
        raise ValueError(f"relu_pool: H and W must be even, got {h}x{w}")
    if w * c >= 2**31:
        raise ValueError(f"relu_pool: a row of W*C = {w * c} elements is too long")
    return b, c, h, w


def _kernel_fwd(x: torch.Tensor) -> torch.Tensor:
    b, c, h, w = _check_input(x)
    _check("x", x, (b, c, h, w), x.dtype)
    y = torch.empty((b, c, h // 2, w // 2), dtype=x.dtype, device=x.device,
                    memory_format=torch.channels_last)
    lib = _library()
    with torch.cuda.device(x.device):
        err = lib.relu_pool_fwd(
            x.data_ptr(), y.data_ptr(), b, h, w, c, _DTYPE_CODE[x.dtype],
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err:
        raise RuntimeError(f"relu_pool_fwd launch failed with CUDA error {err}")
    LAUNCHES["relu_pool_fwd"] += 1
    return y


def _kernel_bwd(x: torch.Tensor, y: torch.Tensor, ct: torch.Tensor) -> torch.Tensor:
    b, c, h, w = _check_input(x)
    _check("x", x, (b, c, h, w), x.dtype)
    _check("y", y, (b, c, h // 2, w // 2), x.dtype)
    _check("ct", ct, (b, c, h // 2, w // 2), x.dtype)
    g = torch.empty_like(x, memory_format=torch.channels_last)
    lib = _library()
    with torch.cuda.device(x.device):
        err = lib.relu_pool_bwd(
            x.data_ptr(), y.data_ptr(), ct.data_ptr(), g.data_ptr(), b, h, w, c,
            _DTYPE_CODE[x.dtype], torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err:
        raise RuntimeError(f"relu_pool_bwd launch failed with CUDA error {err}")
    LAUNCHES["relu_pool_bwd"] += 1
    return g


def relu_pool_fwd_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain torch ``max_pool(relu(x), 2)`` of an NCHW tensor (6-D window
    view and ``amax``); returns channels_last memory like the kernel."""
    b, c, h, w = _check_input(x)
    xh = x.permute(0, 2, 3, 1).reshape(b, h // 2, 2, w // 2, 2, c)
    y = torch.clamp_min(xh.amax(dim=(2, 4)), 0)
    return y.permute(0, 3, 1, 2)


def relu_pool_bwd_plain(x: torch.Tensor, y: torch.Tensor, ct: torch.Tensor) -> torch.Tensor:
    """Plain torch tie-to-all gradient: ``ct`` where ``x > 0 and x == y``."""
    b, c, h, w = _check_input(x)
    x6 = x.permute(0, 2, 3, 1).reshape(b, h // 2, 2, w // 2, 2, c)
    y6 = y.permute(0, 2, 3, 1)[:, :, None, :, None, :]
    ct6 = ct.to(x.dtype).permute(0, 2, 3, 1)[:, :, None, :, None, :]
    g6 = torch.where((x6 > 0) & (x6 == y6), ct6, 0.0)
    return g6.reshape(b, h, w, c).permute(0, 3, 1, 2)


def relu_pool_fwd(x: torch.Tensor) -> torch.Tensor:
    """``max_pool(relu(x), 2)``: the kernel for a CUDA tensor, the plain
    version for a CPU tensor."""
    if x.device.type == "cuda":
        return _kernel_fwd(x)
    if x.device.type == "cpu":
        return relu_pool_fwd_plain(x)
    raise ValueError(f"relu_pool_fwd: unsupported device {x.device}")


def relu_pool_bwd(x: torch.Tensor, y: torch.Tensor, ct: torch.Tensor) -> torch.Tensor:
    """Gradient of ``max_pool(relu(x), 2)``; dispatch as :func:`relu_pool_fwd`."""
    if x.device.type == "cuda":
        return _kernel_bwd(x, y, ct)
    if x.device.type == "cpu":
        return relu_pool_bwd_plain(x, y, ct)
    raise ValueError(f"relu_pool_bwd: unsupported device {x.device}")


class ReluMaxPool2(torch.autograd.Function):
    """``max_pool(relu(x), 2)`` with the tie-to-all backward; saves
    ``(x, y)`` like the JAX VJP."""

    @staticmethod
    def forward(ctx, x):
        y = relu_pool_fwd(x)
        ctx.save_for_backward(x, y)
        return y

    @staticmethod
    def backward(ctx, ct):
        x, y = ctx.saved_tensors
        # the kernel reads NHWC bytes; the incoming gradient already is
        # channels_last when it comes from a channels_last conv
        ct = ct.to(x.dtype).contiguous(memory_format=torch.channels_last)
        return relu_pool_bwd(x, y, ct)


def relu_max_pool(x: torch.Tensor) -> torch.Tensor:
    """Fused relu + 2x2 max-pool of an NCHW (channels_last) tensor."""
    return ReluMaxPool2.apply(x)
