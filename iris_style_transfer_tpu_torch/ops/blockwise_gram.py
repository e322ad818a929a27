"""Blockwise Gram matrix of style features, with its gradient.

Replaces the JAX package's TPU kernel ``ops/pallas_gram.py:
gram_matrix_pallas`` with the hand-written Hopper kernels in
``ops/csrc/gram.cu``:

    G[b] = X_b^T X_b / n,   X_b the (H*W, C) pixels of image b,
    n = C*H*W (batched convention) or H*W

in float32 for float32 or bfloat16 features.  The gradient is the JAX
package's custom VJP, ``dX = X (G_bar + G_bar^T) / n``: one batched
``torch.matmul`` in f32, outside the kernel, as the JAX package leaves it to
XLA outside its Pallas kernel (``pallas_gram.py:68-74``).  It is returned
in x's dtype with channels_last memory.

Features are NCHW-shaped with channels_last memory (NHWC bytes); the
kernels read them as (B, H*W, C) with no transpose, and
:func:`gram_matrix` makes a tap in another layout channels_last first.
Dispatch follows the tensor's device: a CUDA tensor launches a kernel (or
raises), a CPU tensor takes the plain version, ``ops/gram.py:gram_matrix``.
The TPU kernel's rules (HW >= 128^2, a ragged fallback to XLA) are tiling
rules of the TPU; the Hopper kernels take every shape.

Which kernel runs is decided by :func:`plan` from the dtype, the shape and
x's alignment, before launch: bfloat16 with C % 8 == 0 and a 16-byte
aligned x (every main path) takes ``gram_tc_kernel`` (TMA into an mbarrier
ring, wgmma on the tensor cores, persistent blocks); float32, and bfloat16
that TMA cannot read (rows of C % 8 != 0 channels are not 16-byte
multiples), take ``gram_fma_kernel`` on the CUDA cores.  A build or launch
error raises; nothing falls back.  :func:`plan` also splits HW (split-K)
and lays out the work items; :func:`decode` gives an item's image, tile
pair and pixels as the kernels do, so the CPU tests hold the plan.

Tolerances on the card, both scaled by max|G|, which bounds every entry's
sum of |terms| (Cauchy-Schwarz: it is the largest diagonal entry):

- against an f64 Gram of the same input (:func:`within_f64_tolerance`),
  ``max|G_k - G_64| <= 1e-5 * max|G_64|``.  The products are exact in f32,
  so only the f32 sums err; each kernel sums a split's steps into its
  accumulators and the split partials in order, which keeps it near 2e-6
  of max|G| at 262,144 pixels, while dropping one 32-pixel step at 512 px
  costs about 1e-4.
- against the plain f32 bmm with TF32 off (:func:`within_tolerance`),
  ``max|G_k - G_p| <= 1e-4 * max|G_p|``, a second witness whose own
  rounding (cuBLAS's long sums) takes up most of that bound at 512 px.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from .cuda_build import load_library
from .gram import gram_matrix as gram_matrix_plain

SOURCE = "gram.cu"
# launches of the kernels in this process; the wrapper adds one per launch
# and nothing else touches it except callers resetting it
LAUNCHES = {"gram_matrix": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
N_SM = 132  # the H100's SMs: the default of plan() for the CPU tests
MAX_GRID_X = 2**31 - 1
MAX_SMEM = 232_448  # dynamic shared memory a block can have on Hopper
_FMA_TILE, _FMA_STEP, _FMA_THREADS = 64, 32, 256  # gram_fma_kernel's tile edge, pixels a step, block
_FMA_TARGET_BLOCKS = 528  # 4 blocks per SM on 132 SMs
_TC_RING = 192 * 1024  # gram_tc_kernel's ring of stages, bytes
_TC_ITEM_COST = 2  # a work item's set-up and store, in stages, for the split choice
_lib = None


class Plan(NamedTuple):
    """One launch.  Work items are (image, tile pair ti <= tj, split),
    numbered with the pair fastest, then the split; block k takes items k,
    k + blocks, ...  Split s holds pixels [s * chunk, min((s + 1) * chunk,
    HW)), chunk a multiple of ``step``."""

    kernel: str  # "tc" (tensor cores) or "fma" (CUDA cores)
    wg: int  # consumer warpgroups of the tensor-core kernel (0 for "fma")
    tile: int  # output tile edge, channels
    step: int  # pixels a step
    stages: int  # shared-memory ring stages ("tc"; 1 for "fma")
    threads: int
    n_tiles: int
    pairs: int  # upper-triangle tile pairs of an image
    splits: int
    chunk: int  # pixels of a split
    items: int  # B * splits * pairs
    blocks: int
    smem: int  # shared memory bytes of a block (dynamic for "tc", static for "fma")


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _tc_splits(npi: int, hw: int, step: int, tile: int, out_bytes: int, n_sm: int) -> int:
    """The split count of the persistent kernel, from a model in bytes: the
    waves of items times an item's loads (a stage is 32 KB, half of it on a
    diagonal tile) and its tile's store, each SM at its share of 3.35 TB/s;
    more than one split adds the (S, B, C, C) partials' write and the
    reduction's read and its launch (~3 us).  Tried up to four waves' worth
    of splits; ties go to fewer splits."""
    steps = _cdiv(hw, step)
    sm_rate, hbm_rate = 3.35e12 / n_sm, 3.35e12
    best, best_cost = 1, None
    for s in range(1, max(1, min(steps, _cdiv(4 * n_sm, npi))) + 1):
        per = _cdiv(steps, s)
        s_eff = _cdiv(steps, per)
        waves = _cdiv(npi * s_eff, min(npi * s_eff, n_sm))
        cost = waves * (per * 24 * 1024 + tile * tile * 4) / sm_rate
        if s_eff > 1:
            cost += 2 * s_eff * out_bytes / hbm_rate + 3e-6
        if best_cost is None or cost < best_cost:
            best, best_cost = s_eff, cost
    return best


@functools.lru_cache(maxsize=256)
def plan(shape: tuple[int, int, int, int], dtype: torch.dtype, aligned: bool, n_sm: int = N_SM) -> Plan:
    """The launch for NCHW ``shape`` features of ``dtype`` (``aligned``: x
    16-byte aligned) on a card of ``n_sm`` SMs.  Raises where the FMA
    kernel's one block per item would pass the grid's 2^31 - 1."""
    b, c, h, w = shape
    hw = h * w
    tc = dtype == torch.bfloat16 and c % 8 == 0 and aligned and hw < 2**31 and b < 2**31
    if tc:
        wg = 1 if c <= 64 else 2
        tile, step = 64 * wg, 128 // wg  # a stage: A's and B's boxes of step pixels x 64 bf16, 32 KB
        stages = _TC_RING // (2 * wg * step * 128)
        threads, smem = 128 * wg + 32, _TC_RING + 1024 + 16 * stages
    else:
        wg, tile, step, stages, threads = 0, _FMA_TILE, _FMA_STEP, 1, _FMA_THREADS
        smem = 2 * _FMA_STEP * _FMA_TILE * 4
    n_tiles = _cdiv(c, tile)
    pairs = n_tiles * (n_tiles + 1) // 2
    npi = b * pairs
    if hw == 0 or npi == 0:
        return Plan("tc" if tc else "fma", wg, tile, step, stages, threads, n_tiles, pairs, 0, step, 0, 0, smem)
    if tc:
        s = _tc_splits(npi, hw, step, tile, b * c * c * 4, n_sm)
    else:  # enough blocks to fill the card, each split at least 8 steps
        s = max(1, min(_cdiv(_FMA_TARGET_BLOCKS, npi), _cdiv(hw, 8 * step)))
    chunk = _cdiv(_cdiv(hw, s), step) * step
    s = _cdiv(hw, chunk)  # no empty split
    items = npi * s
    blocks = min(items, n_sm) if tc else items
    if blocks > MAX_GRID_X:
        raise ValueError(f"gram_matrix: {items} work items of {shape} pass the grid's 2^31 - 1 blocks "
                         "(gram_fma_kernel takes one block per item)")
    return Plan("tc" if tc else "fma", wg, tile, step, stages, threads, n_tiles, pairs, s, chunk, items,
                blocks, smem)


def decode(pl: Plan, item: int, hw: int) -> tuple[int, int, int, int, int, int, int]:
    """(block, image, ti, tj, split, p0, p1) of work item ``item``, as the
    kernels number it (``gram.cu:decode``): the tile pair fastest, the
    upper triangle row by row, then the split."""
    pair, rest = item % pl.pairs, item // pl.pairs
    split, image = rest % pl.splits, rest // pl.splits
    ti = 0
    while pair >= pl.n_tiles - ti:
        pair -= pl.n_tiles - ti
        ti += 1
    p0 = split * pl.chunk
    return item % pl.blocks, image, ti, ti + pair, split, p0, min(p0 + pl.chunk, hw)


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = load_library(SOURCE)
        i64, vp, i32 = ctypes.c_int64, ctypes.c_void_p, ctypes.c_int
        lib.gram.argtypes = [vp, vp, vp, i64, i64, i64, i64, i64, i64, i64, ctypes.c_float, i32, i32, vp]
        lib.gram.restype = ctypes.c_int
        _lib = lib
    return _lib


@functools.lru_cache(maxsize=16)
def _n_sm(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


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
    g = torch.empty((b, c, c), dtype=torch.float32, device=x.device)
    if g.numel() == 0:
        return g  # nothing to launch
    pl = plan((b, c, h, w), x.dtype, x.data_ptr() % 16 == 0, _n_sm(x.device.index or 0))
    # the split partials, which a second launch sums in split order (the
    # tensor-core kernel writes G itself at one split).  Freed on return
    # while the kernels may still run: the caching allocator hands the
    # block only to work queued later on this stream
    partials = pl.kernel == "fma" or pl.splits > 1
    ws = torch.empty((pl.splits, b, c, c) if partials else (0,), dtype=torch.float32, device=x.device)
    n = c * h * w if batched_norm else h * w
    lib = _library()
    with torch.cuda.device(x.device):
        err = lib.gram(x.data_ptr(), ws.data_ptr(), g.data_ptr(), b, h * w, c, pl.splits, pl.chunk, pl.items,
                       pl.blocks, float(n), _DTYPE_CODE[x.dtype], pl.wg,
                       torch.cuda.current_stream(x.device).cuda_stream)
    if err < 0:
        raise RuntimeError(f"gram: the TMA tensor map of {tuple(x.shape)} was refused (code {err}: -1 no "
                           "cuTensorMapEncodeTiled in the CUDA driver library, else -1000 - CUresult)")
    if err:
        raise RuntimeError(f"gram launch failed with CUDA error {err}")
    LAUNCHES["gram_matrix"] += 1
    return g


def gram_fwd(x: torch.Tensor, batched_norm: bool = True) -> torch.Tensor:
    """The Gram of (B, C, H, W) features -> (B, C, C) f32: a kernel for a
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
    differentiable (the counterpart of ``gram_matrix_pallas``).  The kernels
    read NHWC bytes, so a tap in another layout (VGG's after its plain
    pools 2-3) is made channels_last first."""
    return GramMatrix.apply(x.contiguous(memory_format=torch.channels_last), batched_norm)
