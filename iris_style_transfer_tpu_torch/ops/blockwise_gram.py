"""Blockwise Gram matrix of style features, with its gradient.

Replaces the JAX package's TPU kernel ``ops/pallas_gram.py:
gram_matrix_pallas`` with the hand-written Hopper kernel in
``ops/csrc/gram.cu``:

    G[b] = X_b^T X_b / n,   X_b the (H*W, C) pixels of image b,
    n = C*H*W (batched convention) or H*W

in float32 for float32 or bfloat16 features.  The gradient is the JAX
package's custom VJP, ``dX = X (G_bar + G_bar^T) / n``: one batched
``torch.matmul`` in f32, outside the kernel, as the JAX package leaves it to
XLA outside its Pallas kernel (``pallas_gram.py:68-74``).  It is returned
in x's dtype with channels_last memory.

Features are NCHW-shaped with channels_last memory (NHWC bytes); the
kernel reads them as (B, H*W, C) with no transpose, and
:func:`gram_matrix` makes a tap in another layout channels_last first.  Dispatch follows the tensor's device: a CUDA tensor launches
the kernel (or raises), a CPU tensor takes the plain version,
``ops/gram.py:gram_matrix``.  The TPU kernel's rules (HW >= 128^2, a ragged
fallback to XLA) are tiling rules of the TPU; the Hopper kernel takes every
shape.

Tolerances on the card, both scaled by max|G|, which bounds every entry's
sum of |terms| (Cauchy-Schwarz: it is the largest diagonal entry):

- against an f64 Gram of the same input (:func:`within_f64_tolerance`),
  ``max|G_k - G_64| <= 1e-5 * max|G_64|``.  The products are exact in f32,
  so only the f32 sums err; the kernel sums 32-pixel steps into a register
  tile and the split-K partials in order, which keeps it near 2e-6 of
  max|G| at 262,144 pixels, while dropping one 32-pixel step at 512 px
  costs about 1e-4.
- against the plain f32 bmm with TF32 off (:func:`within_tolerance`),
  ``max|G_k - G_p| <= 1e-4 * max|G_p|``, a second witness whose own
  rounding (cuBLAS's long sums) takes up most of that bound at 512 px.
"""

from __future__ import annotations

import ctypes

import torch

from .cuda_build import load_library
from .gram import gram_matrix as gram_matrix_plain

SOURCE = "gram.cu"
# launches of the kernel in this process; the wrapper adds one per launch
# and nothing else touches it except callers resetting it
LAUNCHES = {"gram_matrix": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_TILE, _K = 64, 32  # the kernel's output tile edge and pixels per step
_TARGET_BLOCKS = 528  # 4 blocks per SM on 132 SMs
_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = load_library(SOURCE)
        i64, vp = ctypes.c_int64, ctypes.c_void_p
        lib.gram.argtypes = [vp, vp, vp, i64, i64, i64, i64, ctypes.c_float, ctypes.c_int, vp]
        lib.gram.restype = ctypes.c_int
        _lib = lib
    return _lib


def _splits(b: int, c: int, hw: int) -> int:
    """HW splits (split-K): enough blocks to fill the card, each split at
    least 8 steps of ``_K`` pixels."""
    tiles = -(-c // _TILE)
    pairs = tiles * (tiles + 1) // 2
    return max(1, min(-(-_TARGET_BLOCKS // (pairs * b)), -(-hw // (8 * _K)), 65535))


def _kernel_gram(x: torch.Tensor, batched_norm: bool = True) -> torch.Tensor:
    if x.dim() != 4:
        raise ValueError(f"gram_matrix: expected an NCHW tensor, got shape {tuple(x.shape)}")
    b, c, h, w = x.shape
    if not x.is_cuda:
        raise ValueError(f"gram_matrix: expected a CUDA tensor, got {x.device}")
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"gram_matrix: expected dtype float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"gram_matrix: expected channels_last (NHWC) memory, got strides {x.stride()}")
    if b > 65535:
        raise ValueError(f"gram_matrix: batch {b} exceeds the kernel's grid")
    s = _splits(b, c, h * w)
    # freed on return while the kernel may still run: the caching allocator
    # hands the block only to work queued later on this stream
    ws = torch.empty((s, b, c, c), dtype=torch.float32, device=x.device)
    g = torch.empty((b, c, c), dtype=torch.float32, device=x.device)
    n = c * h * w if batched_norm else h * w
    lib = _library()
    with torch.cuda.device(x.device):
        err = lib.gram(x.data_ptr(), ws.data_ptr(), g.data_ptr(), b, h * w, c, s, float(n),
                       _DTYPE_CODE[x.dtype], torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"gram launch failed with CUDA error {err}")
    LAUNCHES["gram_matrix"] += 1
    return g


def gram_fwd(x: torch.Tensor, batched_norm: bool = True) -> torch.Tensor:
    """The Gram of (B, C, H, W) features -> (B, C, C) f32: the kernel for a
    CUDA tensor, the plain version for a CPU tensor.  No gradient."""
    if x.device.type == "cuda":
        return _kernel_gram(x, batched_norm)
    if x.device.type == "cpu":
        return gram_matrix_plain(x, batched_norm)
    raise ValueError(f"gram_matrix: unsupported device {x.device}")


def _within(g: torch.Tensor, ref: torch.Tensor, rtol: float) -> tuple[bool, float]:
    if not ref.numel():
        return True, 0.0
    err = (g.double() - ref.double()).abs().max().item()
    return err <= rtol * ref.abs().max().item(), err


def within_tolerance(g_kernel: torch.Tensor, g_plain: torch.Tensor) -> tuple[bool, float]:
    """The kernel-vs-plain bound stated in the module docstring; returns
    ``(ok, max_abs_err)``."""
    return _within(g_kernel, g_plain, 1e-4)


def gram_f64(x: torch.Tensor, batched_norm: bool = True) -> torch.Tensor:
    """The Gram of (B, C, H, W) features in float64, the exact reference."""
    b, c, h, w = x.shape
    flat = x.double().permute(0, 2, 3, 1).reshape(b, h * w, c)
    return flat.transpose(1, 2) @ flat / (c * h * w if batched_norm else h * w)


def within_f64_tolerance(g_kernel: torch.Tensor, g_f64: torch.Tensor) -> tuple[bool, float]:
    """The kernel-vs-f64 bound stated in the module docstring; returns
    ``(ok, max_abs_err)``."""
    return _within(g_kernel, g_f64, 1e-5)


class GramMatrix(torch.autograd.Function):
    """``G = X^T X / n`` with the JAX package's VJP; saves ``x``."""

    @staticmethod
    def forward(ctx, x, batched_norm: bool = True):
        ctx.save_for_backward(x)
        ctx.batched_norm = batched_norm
        return gram_fwd(x, batched_norm)

    @staticmethod
    def backward(ctx, g_bar):
        (x,) = ctx.saved_tensors
        b, c, h, w = x.shape
        n = c * h * w if ctx.batched_norm else h * w
        sym = (g_bar + g_bar.transpose(1, 2)) / n
        flat = x.permute(0, 2, 3, 1).reshape(b, h * w, c).float()  # a view for channels_last x
        dx = torch.matmul(flat, sym).to(x.dtype)
        return dx.reshape(b, h, w, c).permute(0, 3, 1, 2), None


def gram_matrix(x: torch.Tensor, batched_norm: bool = True) -> torch.Tensor:
    """Normalized Gram matrix of (B, C, H, W) features -> (B, C, C) float32,
    differentiable (the counterpart of ``gram_matrix_pallas``).  The kernel
    reads NHWC bytes, so a tap in another layout (VGG's after its plain
    pools 2-3) is made channels_last first."""
    return GramMatrix.apply(x.contiguous(memory_format=torch.channels_last), batched_norm)
