"""Per-channel spatial (sum, sum of squares) of a style tap, with its
gradient: the statistics of the BN style loss on its classic path.

    forward : s1[b,c] = sum_hw f;  s2[b,c] = sum_hw f*f    float32, from f in bf16 or f32
    backward: g = (g1[b,c] + 2 * (g2[b,c] * f)).to(f.dtype)

Replaces no Pallas kernel: the JAX package computes these sums in plain
jnp (``ops/losses.py:style_stats``) and XLA fuses the chain.  On a CUDA
tensor :func:`style_sums` runs the hand-written Hopper kernels of
``ops/csrc/style_sums.cu``, which read the tap once forward, and read it
and write the gradient once backward; on a CPU tensor it runs the plain
torch version beside them, the eager chain the port used before (a float32
copy, two sums; autograd's gradient of it, which :func:`style_sums_bwd_plain`
equals bit for bit on the CPU).  There is no relu here: the classic path's
taps are relu outputs already, and the fused relu + sums of the stats taps
is ``ops/relu_stats.py``.

Tensors are (B, C, H, W).  The kernels read channels_last (NHWC) or
NCHW-contiguous memory as it comes, choosing by the strides; a tensor in
neither is copied to NCHW-contiguous first (counted in ``COPIES``).  A
thread moves 16 bytes a load where the innermost extent (C in NHWC, H*W in
NCHW) is a multiple of 8 bf16 or 4 float32 elements and the tensor is
16-byte aligned, and one element otherwise (:func:`plan`).

Kernel vs plain on the card: ``g`` is bit-exact (the same float32
expression rounded in the same order, one cast).  ``s1`` and ``s2`` differ
only in the order of the float32 sums; the stated tolerance
(:func:`sums_within_tolerance`) is ``|s - s_exact| <= 1e-6 * sum|terms|``
per (b, c) against float64 sums, and two runs are bit-equal (no atomics).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from .cuda_build import load_library

SOURCE = "style_sums.cu"
# calls of each entry that launched on the card in this process (the forward
# is two launches, the split pass and the ordered reduce; the backward one)
LAUNCHES = {"style_sums_fwd": 0, "style_sums_bwd": 0}
COPIES = {"style_sums": 0}  # taps in neither layout, copied to NCHW first

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_LAYOUT_CODE = {"nhwc": 0, "nchw": 1}
THREADS = 256  # the kernels' block size
WARPS = THREADS // 32
TARGET_BLOCKS = 2048  # blocks to aim for: about 16 per SM on 132 SMs
MIN_LOADS = 8  # 16-byte loads a thread keeps at least, where that still gives FILL_BLOCKS
FILL_BLOCKS = 264  # two blocks per SM
MAX_GRID_X = 2**31 - 1
_lib = None


class Plan(NamedTuple):
    """Both kernels' grid.  NHWC: block k is split ``k % splits`` of channel
    tile ``k // splits % ceil(C / (cg * vec))`` of image ``k // (splits *
    ctiles)``; its ``cg`` channel groups of ``vec`` channels times ``256 //
    cg`` pixel lanes read pixels ``[s * chunk, +chunk)``.  NCHW: warp w of
    block k reads elements ``[s * chunk, +chunk)`` of plane ``(k // splits)
    * 8 + w``, ``chunk`` a multiple of ``vec``."""

    layout: str
    vec: int
    cg: int
    splits: int
    chunk: int
    blocks: int


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = load_library(SOURCE)
        i64, vp, i32 = ctypes.c_int64, ctypes.c_void_p, ctypes.c_int
        lib.style_sums_fwd.argtypes = [vp, vp, vp, vp, vp, i64, i64, i64, i64, i64, i64, i64, i32, i32, i32, vp]
        lib.style_sums_fwd.restype = ctypes.c_int
        lib.style_sums_bwd.argtypes = [vp, vp, vp, vp, i64, i64, i64, i64, i64, i64, i64, i32, i32, i32, vp]
        lib.style_sums_bwd.restype = ctypes.c_int
        _lib = lib
    return _lib


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=256)
def plan(shape: tuple[int, int, int, int], dtype: torch.dtype, layout: str, aligned: bool = True) -> Plan:
    """The grid for a (B, C, H, W) ``shape`` of ``dtype`` in ``layout``
    ("nhwc" or "nchw"), ``aligned`` if the tensor starts on 16 bytes.  The
    HW splits give about ``TARGET_BLOCKS`` blocks, keep ``MIN_LOADS``
    loads a thread where that still leaves ``FILL_BLOCKS``, and are never
    empty or narrower than one load for each of a block's lanes.  Raises
    past 2^31 - 1 blocks."""
    b, c, h, w = shape
    hw = h * w
    wide = 16 // torch.empty((), dtype=dtype).element_size()
    inner = c if layout == "nhwc" else hw
    vec = wide if aligned and inner % wide == 0 else 1
    if layout == "nhwc":
        cg = min(_cdiv(c, vec), THREADS)
        lanes = THREADS // cg  # pixels a block reads at once
        tiles = b * _cdiv(c, cg * vec)
    elif layout == "nchw":
        cg = 0
        lanes = 32 * vec  # elements a warp reads at once
        tiles = _cdiv(b * c, WARPS)
    else:
        raise ValueError(f"style_sums: unknown layout {layout!r}")
    s = min(_cdiv(TARGET_BLOCKS, tiles), _cdiv(hw, lanes),
            max(_cdiv(hw, lanes * MIN_LOADS), _cdiv(FILL_BLOCKS, tiles)))
    s = max(1, s)
    chunk = _cdiv(hw, s)
    if layout == "nchw":
        chunk = _cdiv(chunk, vec) * vec
    s = _cdiv(hw, chunk)  # no empty split
    pl = Plan(layout, vec, cg, s, chunk, s * tiles)
    if pl.blocks > MAX_GRID_X:
        raise ValueError(f"style_sums: {shape} needs {pl.blocks} blocks along the grid's x, past its 2^31 - 1")
    return pl


def _layout(f: torch.Tensor) -> str | None:
    if f.is_contiguous(memory_format=torch.channels_last):
        return "nhwc"
    return "nchw" if f.is_contiguous() else None


def _check_input(f: torch.Tensor) -> None:
    if f.dim() != 4:
        raise ValueError(f"style_sums: expected a (B, C, H, W) tensor, got shape {tuple(f.shape)}")
    if f.dtype not in _DTYPE_CODE:
        raise ValueError(f"style_sums: the kernels take float32 or bfloat16, got {f.dtype}")


def _kernel_input(f: torch.Tensor) -> tuple[torch.Tensor, Plan]:
    _check_input(f)
    layout = _layout(f)
    if layout is None:
        f = f.contiguous()
        COPIES["style_sums"] += 1
        layout = "nchw"
    return f, plan(tuple(f.shape), f.dtype, layout, f.data_ptr() % 16 == 0)


def _kernel_fwd(f: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    f, pl = _kernel_input(f)
    b, c, h, w = f.shape
    s1 = torch.empty((b, c), dtype=torch.float32, device=f.device)
    s2 = torch.empty((b, c), dtype=torch.float32, device=f.device)
    if f.numel() == 0:
        return s1.zero_(), s2.zero_()
    # freed on return while the kernels may still run: the caching allocator
    # hands the block only to work queued later on this stream
    ws = torch.empty((2, pl.splits, b, c), dtype=torch.float32, device=f.device)
    with torch.cuda.device(f.device):
        err = _library().style_sums_fwd(
            f.data_ptr(), ws[0].data_ptr(), ws[1].data_ptr(), s1.data_ptr(), s2.data_ptr(), b, h * w, c,
            pl.splits, pl.cg, pl.chunk, pl.blocks, _LAYOUT_CODE[pl.layout], pl.vec, _DTYPE_CODE[f.dtype],
            torch.cuda.current_stream(f.device).cuda_stream,
        )
    if err:
        raise RuntimeError(f"style_sums_fwd launch failed with CUDA error {err}")
    LAUNCHES["style_sums_fwd"] += 1
    return s1, s2


def _kernel_bwd(f: torch.Tensor, g1: torch.Tensor, g2: torch.Tensor) -> torch.Tensor:
    f, pl = _kernel_input(f)
    b, c, h, w = f.shape
    for name, t in (("g1", g1), ("g2", g2)):
        if not (t.is_cuda and t.dtype == torch.float32 and tuple(t.shape) == (b, c) and t.is_contiguous()):
            raise ValueError(f"style_sums: {name} must be a contiguous float32 CUDA tensor of shape {(b, c)}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    g = torch.empty_like(f)
    if f.numel() == 0:
        return g
    with torch.cuda.device(f.device):
        err = _library().style_sums_bwd(
            f.data_ptr(), g1.data_ptr(), g2.data_ptr(), g.data_ptr(), b, h * w, c, pl.splits, pl.cg, pl.chunk,
            pl.blocks, _LAYOUT_CODE[pl.layout], pl.vec, _DTYPE_CODE[f.dtype],
            torch.cuda.current_stream(f.device).cuda_stream,
        )
    if err:
        raise RuntimeError(f"style_sums_bwd launch failed with CUDA error {err}")
    LAUNCHES["style_sums_bwd"] += 1
    return g


def style_sums_fwd_plain(f: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain torch ``(sum_hw f, sum_hw f*f)`` over the last two axes, in float32."""
    ff = f.float()
    return ff.sum(dim=(-2, -1)), (ff * ff).sum(dim=(-2, -1))


def style_sums_bwd_plain(f: torch.Tensor, g1: torch.Tensor, g2: torch.Tensor) -> torch.Tensor:
    """Plain torch gradient ``g1 + 2 * (g2 * f)`` in float32, cast once to f's dtype."""
    return (g1.float()[..., None, None] + 2.0 * (g2.float()[..., None, None] * f.float())).to(f.dtype)


def style_sums_fwd(f: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(s1, s2)``: the kernels for a CUDA tensor, the plain version for a
    CPU tensor."""
    if f.device.type == "cuda":
        return _kernel_fwd(f)
    if f.device.type == "cpu":
        return style_sums_fwd_plain(f)
    raise ValueError(f"style_sums_fwd: unsupported device {f.device}")


def style_sums_bwd(f: torch.Tensor, g1: torch.Tensor, g2: torch.Tensor) -> torch.Tensor:
    """Gradient of :func:`style_sums_fwd`; dispatch as there."""
    if f.device.type == "cuda":
        return _kernel_bwd(f, g1, g2)
    if f.device.type == "cpu":
        return style_sums_bwd_plain(f, g1, g2)
    raise ValueError(f"style_sums_bwd: unsupported device {f.device}")


def sums_within_tolerance(s: torch.Tensor, f: torch.Tensor, square: bool) -> tuple[bool, float]:
    """``s`` (s1, or s2 if ``square``) against float64 sums of ``f``: the
    bound stated in the module docstring; returns ``(ok, largest error
    over sum|terms|)``."""
    t = f.double()
    t = t * t if square else t
    exact, scale = t.sum(dim=(-2, -1)), t.abs().sum(dim=(-2, -1))
    err = (s.double() - exact).abs()
    worst = (err / scale.clamp_min(1e-300)).max().item() if err.numel() else 0.0
    return bool((err <= 1e-6 * scale).all()), worst


class StyleSums(torch.autograd.Function):
    """``(s1, s2) = style_sums(f)``; saves ``f``.  A cotangent of an output
    the loss does not use arrives as None and counts as zero."""

    @staticmethod
    def forward(ctx, f):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(f)
        return style_sums_fwd(f)

    @staticmethod
    def backward(ctx, g1, g2):
        (f,) = ctx.saved_tensors
        zero = torch.zeros(f.shape[:-2], dtype=torch.float32, device=f.device)
        g1 = zero if g1 is None else g1.float().contiguous()
        g2 = zero if g2 is None else g2.float().contiguous()
        return style_sums_bwd(f, g1, g2)


def style_sums(f: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-(B, C) float32 sum and sum of squares over H and W of a (B, C,
    H, W) tensor, differentiable in both."""
    return StyleSums.apply(f)
