"""The compact L-BFGS step's work on the (m, N) history: three passes.

    pair     : (y.s, y.y, |g|_1) with y = g - prev_g, s = prev_step      (3,) float32
    dots     : slot w <- (T(s), T(y)) if accept; then, with gb = T(g) and
               the slot's rows after the write, the (5, m) float32 dots
               S_j.gb, Y_j.gb, s_w.Y_j, S_j.y_w, y_w.Y_j                  (DOTS)
    direction: lr * -(gamma*g + top@S + gamma*(bot@Y))                    float32, g's shape

T is the history's type (bfloat16 or float32); g, prev_g, prev_step and the
update are float32 and share one shape of N elements; the history is (m,
*shape).  The kernels read all of them as flat memory, so they take one
dense memory order (contiguous, or channels_last as the VGG stack hands
the NST its gradient) that every history row shares too
(``transfer/lbfgs.py`` lays the history out so).  ``accept`` (a bool) and
``w`` (the slot, int64, shape (1,)) are device tensors, read where they
lie: nothing here waits for the device.

Replaces no Pallas kernel: the JAX package's compact direction is plain jnp
(``transfer/lbfgs.py:_compact_direction``).  On a CUDA tensor
:func:`passes` gives the hand-written kernels of ``ops/csrc/lbfgs.cu``,
which read the history where it lies (twice a step, dots and direction)
and sum in float32 in a fixed order; on a CPU tensor the plain torch
version beside them, which copies the history to float32 and takes
products.  The caller (``transfer/lbfgs.py``) carries SY and YY and runs
the (m,) and (m, m) algebra between the dots and the direction.

Kernel vs plain: the slot write, gb and the elementwise rounding of the
direction are the same; the sums differ.  The plain dots are float64 sums
rounded once to float32 (the pair's and the direction's are float32, as
the port computed them before the kernels); the kernels sum in float32 in
a fixed order.  Their stated tolerance (:func:`within_sum_bound`) is the
standard bound of a recursive float32 sum, ``|s - s_exact| <= depth *
2^-24 * sum|terms|`` against float64, with ``depth`` the longest chain of
additions any sum takes (:func:`sum_depth`).  Two runs are bit-equal: no
atomics, a grid that depends on N alone.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, NamedTuple

import torch

from .cuda_build import load_library

SOURCE = "lbfgs.cu"
# calls of each pass that launched on the card in this process (pair and dots
# are two launches each, the pass and its ordered reduce; direction one)
LAUNCHES = {"lbfgs_pair": 0, "lbfgs_dots": 0, "lbfgs_direction": 0}
DOTS = ("S_j.gb", "Y_j.gb", "s_w.Y_j", "S_j.y_w", "y_w.Y_j")  # the rows of the dots pass's (5, m) output

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
THREADS = 256  # the kernels' block size
PARTIAL_BLOCKS = 264  # blocks of the pair and dots passes: two per SM on 132 SMs
ROWS = 10  # rows of S and of Y a dots block keeps (its 5 sums a row in registers): lbfgs.cu's kRows
MAX_GRID_X = 2**31 - 1
_lib = None


class Plan(NamedTuple):
    """The passes' grid for N elements.  ``vec``: history elements a thread
    moves a load (16 bytes' worth, else 1); ``blocks``: the pair and dots passes' grid
    along x, each block one row of partials; ``chunks``: the dots pass's
    grid along y, ceil(m / ROWS), chunk c holding rows [c * ROWS, +ROWS)
    of S and Y; ``dir_blocks``: the direction pass's grid."""

    vec: int
    blocks: int
    chunks: int
    dir_blocks: int


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = load_library(SOURCE)
        i64, vp, i32 = ctypes.c_int64, ctypes.c_void_p, ctypes.c_int
        lib.lbfgs_pair.argtypes = [vp, vp, vp, vp, vp, i64, i64, i32, vp]
        lib.lbfgs_pair.restype = ctypes.c_int
        lib.lbfgs_dots.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp, vp, i64, i64, i64, i64, i32, i32, vp]
        lib.lbfgs_dots.restype = ctypes.c_int
        lib.lbfgs_direction.argtypes = [vp, vp, vp, vp, vp, vp, vp, ctypes.c_float, i64, i64, i64, i32, i32, vp]
        lib.lbfgs_direction.restype = ctypes.c_int
        _lib = lib
    return _lib


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=64)
def plan(n: int, m: int, dtype: torch.dtype, aligned: bool = True) -> Plan:
    """The grid for N = ``n`` elements and ``m`` history rows of ``dtype``,
    ``aligned`` if every pointer starts on 16 bytes (the pair pass reads
    float32 alone: its plan is ``plan(n, 1, torch.float32)``).  Raises past
    2^31 - 1 blocks."""
    wide = 16 // torch.empty((), dtype=dtype).element_size()
    vec = wide if aligned and n % wide == 0 else 1
    blocks = max(1, min(PARTIAL_BLOCKS, _cdiv(n // vec, THREADS)))
    dir_blocks = max(1, _cdiv(n // vec, THREADS))
    if dir_blocks > MAX_GRID_X:
        raise ValueError(f"lbfgs: N = {n} needs {dir_blocks} blocks along the grid's x, past its 2^31 - 1")
    return Plan(vec, blocks, _cdiv(m, ROWS), dir_blocks)


def sum_depth(n: int, pl: Plan) -> int:
    """The longest chain of float32 additions that a sum of the pair or
    dots pass planned as ``pl`` takes at N = ``n``: a thread's elements in
    order, the warp's butterfly (5), the block's warps (7), the blocks'
    lane-strided sums and their butterfly (5)."""
    per_thread = _cdiv(n // pl.vec, pl.blocks * THREADS) * pl.vec
    return per_thread + 5 + 7 + _cdiv(pl.blocks, 32) + 5


def within_sum_bound(got: torch.Tensor, terms: torch.Tensor, depth: int) -> tuple[bool, float]:
    """``got`` (float32, any shape) against the float64 sums of ``terms``
    (``got``'s shape plus a last axis of the summed terms): each within
    ``depth * 2^-24 * sum|terms|``.  Returns (ok, the largest error over
    sum|terms|)."""
    t = terms.double()
    err = (got.double() - t.sum(-1)).abs()
    scale = t.abs().sum(-1)
    worst = (err / scale.clamp_min(1e-300)).max().item() if err.numel() else 0.0
    return bool((err <= depth * 2.0**-24 * scale).all()), worst


# ------------------------------------------------------------------ plain


def pair_dots_plain(g: torch.Tensor, prev_g: torch.Tensor, prev_step: torch.Tensor) -> torch.Tensor:
    """Plain torch ``(y.s, y.y, |g|_1)`` in float32."""
    y = g - prev_g
    return torch.stack([(y * prev_step).sum(), (y * y).sum(), g.abs().sum()])


def history_dots_plain(s_hist, y_hist, g, prev_g, prev_step, accept, w) -> torch.Tensor:
    """Plain torch: the new pair into slot ``w`` on ``accept`` (in place; the
    old row back otherwise), then the (5, m) dots of :data:`DOTS`, summed
    in float64 and rounded once to float32."""
    for buf, v in ((s_hist, prev_step), (y_hist, g - prev_g)):
        row = torch.where(accept, v.to(buf.dtype), buf.index_select(0, w)[0])
        buf.index_copy_(0, w, row[None])
    m = s_hist.shape[0]
    S, Y = s_hist.reshape(m, -1).double(), y_hist.reshape(m, -1).double()
    gb = g.reshape(-1).to(s_hist.dtype).double()
    sw, yw = S.index_select(0, w)[0], Y.index_select(0, w)[0]
    return torch.stack([S @ gb, Y @ gb, Y @ sw, S @ yw, Y @ yw]).float()


def direction_plain(s_hist, y_hist, g, top, bot, gamma, lr: float) -> torch.Tensor:
    """Plain torch ``lr * -(gamma*g + top@S + gamma*(bot@Y))`` in float32."""
    m = s_hist.shape[0]
    St = (top @ s_hist.reshape(m, -1).float()).reshape(g.shape)
    Yb = (bot @ y_hist.reshape(m, -1).float()).reshape(g.shape)
    return lr * -(gamma * g + St + gamma * Yb)


# ------------------------------------------------------------------ kernels


def _check_vectors(*ts: torch.Tensor) -> None:
    g = ts[0]
    dense = g.is_contiguous() or (g.dim() == 4 and g.is_contiguous(memory_format=torch.channels_last))
    for t in ts:
        if not (dense and t.is_cuda and t.device == g.device and t.dtype == torch.float32 and t.numel() > 0
                and t.shape == g.shape and t.stride() == g.stride()):
            raise ValueError(f"lbfgs: g, prev_g, prev_step and the update must be float32 CUDA tensors of one "
                             f"shape and one dense memory order (contiguous or channels_last) on one device, got "
                             f"{t.dtype} {tuple(t.shape)} strides {t.stride()} on {t.device} beside g's "
                             f"{tuple(g.shape)} strides {g.stride()}")


def _check_history(s_hist: torch.Tensor, y_hist: torch.Tensor, g: torch.Tensor) -> None:
    for t in (s_hist, y_hist):
        if not (t.device == g.device and t.dtype in _DTYPE_CODE and t.dtype == s_hist.dtype and t.shape[0] > 0
                and t.shape[1:] == g.shape and t.stride() == (g.numel(), *g.stride())):
            raise ValueError(f"lbfgs: the history must be two float32 or bfloat16 (m, *g.shape) buffers on "
                             f"{g.device} whose rows have g's memory order (strides {g.stride()}), got {t.dtype} "
                             f"{tuple(t.shape)} strides {t.stride()} on {t.device}")


def _device_scalar(name: str, t: torch.Tensor, dtype: torch.dtype, numel: int, device) -> None:
    if not (t.device == device and t.dtype == dtype and t.numel() == numel and t.is_contiguous()):
        raise ValueError(f"lbfgs: {name} must be a contiguous {dtype} tensor of {numel} element(s) on {device}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")


def _aligned(*ts: torch.Tensor) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in ts)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(err: int, name: str) -> None:
    if err:
        raise RuntimeError(f"{name} launch failed with CUDA error {err}")


def _kernel_pair(g: torch.Tensor, prev_g: torch.Tensor, prev_step: torch.Tensor) -> torch.Tensor:
    _check_vectors(g, prev_g, prev_step)
    n = g.numel()
    out = torch.empty(3, dtype=torch.float32, device=g.device)
    pl = plan(n, 1, torch.float32, _aligned(g, prev_g, prev_step))
    # freed on return while the kernels may still run: the caching allocator
    # hands the block only to work queued later on this stream
    ws = torch.empty((pl.blocks, 3), dtype=torch.float32, device=g.device)
    with torch.cuda.device(g.device):
        err = _library().lbfgs_pair(g.data_ptr(), prev_g.data_ptr(), prev_step.data_ptr(), ws.data_ptr(),
                                    out.data_ptr(), n, pl.blocks, pl.vec, _stream(g))
    _raise_on(err, "lbfgs_pair")
    LAUNCHES["lbfgs_pair"] += 1
    return out


def _kernel_dots(s_hist, y_hist, g, prev_g, prev_step, accept, w) -> torch.Tensor:
    _check_vectors(g, prev_g, prev_step)
    _check_history(s_hist, y_hist, g)
    _device_scalar("accept", accept, torch.bool, 1, g.device)
    _device_scalar("w", w, torch.int64, 1, g.device)
    m, n = s_hist.shape[0], g.numel()
    out = torch.empty((5, m), dtype=torch.float32, device=g.device)
    pl = plan(n, m, s_hist.dtype, _aligned(s_hist, y_hist, g, prev_g, prev_step))
    ws = torch.empty((pl.blocks, 5, m), dtype=torch.float32, device=g.device)
    with torch.cuda.device(g.device):
        err = _library().lbfgs_dots(
            s_hist.data_ptr(), y_hist.data_ptr(), g.data_ptr(), prev_g.data_ptr(), prev_step.data_ptr(),
            accept.data_ptr(), w.data_ptr(), ws.data_ptr(), out.data_ptr(), n, m, pl.blocks, pl.chunks, pl.vec,
            _DTYPE_CODE[s_hist.dtype], _stream(g))
    _raise_on(err, "lbfgs_dots")
    LAUNCHES["lbfgs_dots"] += 1
    return out


def _kernel_direction(s_hist, y_hist, g, top, bot, gamma, lr: float) -> torch.Tensor:
    _check_vectors(g)
    _check_history(s_hist, y_hist, g)
    m, n = s_hist.shape[0], g.numel()
    for name, t in (("top", top), ("bot", bot)):
        _device_scalar(name, t, torch.float32, m, g.device)
    _device_scalar("gamma", gamma, torch.float32, 1, g.device)
    out = torch.empty_like(g)
    pl = plan(n, m, s_hist.dtype, _aligned(s_hist, y_hist, g, out))
    with torch.cuda.device(g.device):
        err = _library().lbfgs_direction(
            s_hist.data_ptr(), y_hist.data_ptr(), g.data_ptr(), top.data_ptr(), bot.data_ptr(), gamma.data_ptr(),
            out.data_ptr(), lr, n, m, pl.dir_blocks, pl.vec, _DTYPE_CODE[s_hist.dtype], _stream(g))
    _raise_on(err, "lbfgs_direction")
    LAUNCHES["lbfgs_direction"] += 1
    return out


class Passes(NamedTuple):
    """One implementation of the three passes, as ``transfer/lbfgs.py``
    calls them."""

    pair: Callable[..., torch.Tensor]
    dots: Callable[..., torch.Tensor]
    direction: Callable[..., torch.Tensor]


PLAIN = Passes(pair_dots_plain, history_dots_plain, direction_plain)
KERNELS = Passes(_kernel_pair, _kernel_dots, _kernel_direction)


def passes(device: torch.device) -> Passes:
    """The kernels for a CUDA device, the plain version for the CPU."""
    if device.type == "cuda":
        return KERNELS
    if device.type == "cpu":
        return PLAIN
    raise ValueError(f"lbfgs: unsupported device {device}")
