"""Fused depthwise conv + eval batchnorm + SiLU, stride 1, with its gradient.

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
version.

:func:`dw_conv_bn_silu` is differentiable in ``x``, ``w``, ``a`` and ``b``
(:class:`DwConvBnSilu`).  The JAX package has no backward kernel for this
function: its gradient is XLA's, through the grouped conv, the batchnorm
and the SiLU.  The gradient, in f32 from ``acc = dwconv(x, w)`` and ``z =
a * acc + b``: ``dz = g * silu'(z)``, ``da = sum_BHW dz * acc``, ``db =
sum_BHW dz``, ``dx`` the flipped-tap depthwise conv of ``a * dz`` (cast to
``x.dtype``) and ``dw`` the per-channel correlation of ``x`` with ``a *
dz`` (in ``w.dtype``).  On a CUDA tensor it is three hand-written kernels
in ``ops/csrc/depthwise.cu`` (:func:`plan_bwd`): a tile pass that
recomputes ``acc``, writes ``a * dz`` in f32 and each tile's partials of
``dw``, ``da`` and ``db``, a dx pass (the forward's conv on ``a * dz``
with the flipped taps) and a reduce pass over the tiles, in a fixed order
with no atomics, so two runs give bit-equal gradients.  On a CPU tensor it
is :func:`dw_conv_bn_silu_bwd`, plain torch: shifted slices, not
``F.conv2d``, so no TF32 enters where it runs on the card.  A cotangent
that is not channels_last is copied to it (counted in ``COPIES``).

The kernel's launch is planned here (:func:`plan`): a thread owns ``vec``
consecutive channels (4 when C is a multiple of 8 and x is 16-byte
aligned, else 1) and a run of ``RUN`` output pixels along W; a block owns
``cvb`` channel vectors of a ``tile_h`` x ``runs * RUN`` pixel tile.  The
backward's tile pass takes the same tiling under a larger shared-memory cap
(:func:`plan_bwd`: it also holds ``a * dz``'s tile in f32 and the partials'
scratch).  The CPU tests hold both plans at every B7 shape: every output
element and every (tile, channel) partial is covered once and the block
fits the card.

Kernel vs plain on the card cannot be bit-exact: the kernel contracts each
tap into an FMA, and the affine too, and its SiLU takes the card's fast
exp and reciprocal (``__expf``, ``__fdividef``, ~1e-6 relative).  The stated tolerance
(:func:`within_tolerance`): float32 ``max|y_k - y_p| <= 1e-5 * max|y_p|``;
bfloat16 every element within one bf16 ulp of the larger magnitude or
within ``1e-5 * max|y_p|`` (where ``a * acc + b`` cancels to near zero, the
f32 rounding of the two forms is many ulps of the tiny result), and
>= 99.9% of elements equal.

The gradient's kernels vs :func:`dw_conv_bn_silu_bwd` on the card
(:func:`grad_within_tolerance`): the kernels sum ``acc`` and dx's taps with
FMAs and the BHW reductions in another order, so dx is held to
:func:`within_tolerance` (bf16: one ulp of the larger magnitude or
``1e-5 * max|dx_p|``, >= 99.9% equal; f32: ``1e-5 * max|dx_p|``) and
``dw``, ``da`` and ``db`` to ``1e-4 * max|g_p|`` each (f32 inputs:
``1e-5``), relative to the largest gradient since the reductions run over
up to B * H * W = 133,120 pixels a channel at B7's shapes.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from .cuda_build import load_library

SOURCE = "depthwise.cu"
# launches of the kernel in this process; the wrapper adds one per launch
# and nothing else touches it except callers resetting it
LAUNCHES = {"dw_conv_bn_silu": 0}
# the same for the backward's three kernels (tile pass, dx pass, reduce)
BWD_LAUNCHES = {"dw_bwd_tile": 0, "dw_bwd_dx": 0, "dw_bwd_reduce": 0}
# cotangents the backward's wrapper copied to channels_last
COPIES = {"gy_channels_last": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_KS = (3, 5)
MAX_THREADS = 256  # the kernel's __launch_bounds__
RUN = 8  # output pixels of a thread's run along W (the kernel's kRun)
MAX_SMEM = 75 * 1024  # a plan's shared memory per block: three blocks per SM, as the registers allow at k = 3
MAX_SMEM_BWD = 110 * 1024  # the backward's tile pass: two blocks per SM (227 KB, 1 KB reserved a block)
REDUCE_LANES, REDUCE_GROUPS = 32, 8  # the reduce kernel's block: channels x tile groups
_WANT_DX, _WANT_W, _WANT_AB = 1, 2, 4  # the tile pass's flags
_lib = None


class Plan(NamedTuple):
    """One launch of the kernel.  A thread owns ``vec`` channels of ``RUN``
    neighbouring output pixels of a row, for the rows ``ty, ty + rows_t,
    ...`` of its block's tile; a block owns ``cvb`` channel vectors
    (``cvb * vec`` channels, one of ``slices``) of a ``tile_h`` x
    ``tile_w`` pixel tile and stages its halo in shared memory."""

    vec: int
    cvb: int
    runs: int  # threads along W: tile_w = runs * RUN
    rows_t: int  # threads along H
    tile_h: int
    tile_w: int
    tiles_h: int
    tiles_w: int
    slices: int
    blocks: int  # bsz * tiles_h * tiles_w * slices
    threads: int  # cvb * runs * rows_t
    smem: int  # bytes of dynamic shared memory


class PlanBwd(NamedTuple):
    """The backward's three launches.  ``tile`` (pass 1) is the forward's
    tiling of x, its ``smem`` grown by ``a * dz``'s tile in f32 and the
    partials' scratch; its blocks' ``(channel, dy)`` dw items run in
    ``groups`` row groups.  ``dx`` (pass 2) is :func:`plan` of the f32
    ``a * dz``.  The workspace holds ``k * k + 2`` partial rows (dw's taps,
    da, db) of every channel for each of the ``tiles`` spatial tiles;
    pass 3 sums them over the tiles in ``reduce_blocks`` blocks of
    ``REDUCE_LANES`` channels x ``REDUCE_GROUPS`` tile groups."""

    tile: Plan
    dx: Plan
    groups: int
    tiles: int  # bsz * tile.tiles_h * tile.tiles_w
    workspace: int  # floats: tiles * (k * k + 2) * C
    reduce_blocks: int  # ceil(C / REDUCE_LANES) * (k * k + 2)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _r16(n: int) -> int:
    return (n + 15) // 16 * 16


def _bwd_groups(k: int, pe: int, threads: int) -> int:
    """Row groups of the tile pass's ``pe * k`` dw items (the kernel's
    ``bwd_groups``): as many as fill the block's threads."""
    return max(1, threads // (pe * k))


def _smem_fwd(k: int, pe: int, vec: int, tile_h: int, tile_w: int, itemsize: int, threads: int) -> int:
    """Bytes of the forward's dynamic shared memory: the parameters (k * k
    taps, a, b in f32) and x's halo tile."""
    params = ((k * k + 2) * pe + 3) // 4 * 4 * 4
    return params + (tile_h + k - 1) * (tile_w + k - 1) * pe * itemsize


def _smem_bwd(k: int, pe: int, vec: int, tile_h: int, tile_w: int, itemsize: int, threads: int) -> int:
    """Bytes of the tile pass's dynamic shared memory (the kernel's
    ``bwd_smem``): the forward's regions, then ``a * dz``'s tile in f32,
    each thread's da and db partials and each (group, tap, channel)'s dw
    partial, each region 16-byte aligned."""
    params = ((k * k + 2) * pe + 3) // 4 * 4 * 4
    halo = (tile_h + k - 1) * (tile_w + k - 1) * pe * itemsize
    return (params + _r16(halo) + _r16(tile_h * tile_w * pe * 4) + _r16(threads * 2 * vec * 4)
            + _bwd_groups(k, pe, threads) * k * k * pe * 4)


def _plan(shape: tuple[int, int, int, int], k: int, itemsize: int, aligned: bool, smem_of, cap: int) -> Plan:
    """The tiling of x for a kernel whose shared memory is ``smem_of(k, pe,
    vec, tile_h, tile_w, itemsize, threads)`` bytes, at most ``cap``: fewer
    rows a thread, then fewer runs, then fewer thread rows, until it fits."""
    bsz, c, h, w = shape
    rows_per_thread, max_cvb = 4, 16
    vec = 4 if c % 8 == 0 and aligned else 1
    nvec = c // vec
    cvb = max(d for d in range(1, min(nvec, max_cvb if vec > 1 else 32) + 1)
              if nvec % d == 0 and (vec == 1 or d * vec % 8 == 0))
    spatial = MAX_THREADS // cvb
    runs_total = _cdiv(w, RUN)
    runs = min(runs_total, max(1, spatial // 4))
    rows_cap = h
    while True:
        tiles_w = _cdiv(runs_total, runs)
        runs = _cdiv(runs_total, tiles_w)
        rows_t = max(1, min(rows_cap, spatial // runs))
        tile_h = min(h, rows_t * rows_per_thread)
        tiles_h = _cdiv(h, tile_h)
        tile_h = _cdiv(h, tiles_h)
        rows_t = min(rows_t, tile_h)
        smem = smem_of(k, cvb * vec, vec, tile_h, runs * RUN, itemsize, cvb * runs * rows_t)
        if smem <= cap or (runs == 1 and rows_per_thread == 1 and rows_t == 1):
            break
        if rows_per_thread > 1:
            rows_per_thread //= 2
        elif runs > 1:
            runs = _cdiv(runs, 2)
        else:
            rows_cap = max(1, rows_t // 2)
    slices = nvec // cvb
    return Plan(vec, cvb, runs, rows_t, tile_h, runs * RUN, tiles_h, tiles_w, slices,
                bsz * tiles_h * tiles_w * slices, cvb * runs * rows_t, smem)


@functools.lru_cache(maxsize=256)
def plan(shape: tuple[int, int, int, int], k: int, itemsize: int, aligned: bool) -> Plan:
    """The launch for an NCHW ``shape``: vectors of 4 channels when C is a
    multiple of 8 and ``aligned`` (x 16-byte aligned), else scalar
    channels; the largest channel slice of at most 16 vectors (32 scalar
    channels) that divides C, whole 16-byte copies for vectors; the rest
    of the block's 256 threads spread over a tile of ``runs`` runs along W
    (at most a quarter of them) and ``rows_t`` rows, each thread taking 4
    rows (fewer where the halo tile would pass ``MAX_SMEM``); tiles evened
    out over the image."""
    return _plan(shape, k, itemsize, aligned, _smem_fwd, MAX_SMEM)


@functools.lru_cache(maxsize=256)
def plan_bwd(shape: tuple[int, int, int, int], k: int, itemsize: int, aligned: bool) -> PlanBwd:
    """The backward's launches for an NCHW ``shape`` of x (``itemsize`` its
    bytes; ``aligned``: x and the cotangent 16-byte aligned): the tile pass
    as :func:`plan` chooses, under ``MAX_SMEM_BWD`` (fewer rows a thread,
    then fewer runs, then fewer thread rows, until it fits), the dx pass
    as :func:`plan` chooses for the f32 ``a * dz``."""
    tile = _plan(shape, k, itemsize, aligned, _smem_bwd, MAX_SMEM_BWD)
    bsz, c = shape[:2]
    tiles = bsz * tile.tiles_h * tile.tiles_w
    return PlanBwd(tile, plan(shape, k, 4, True), _bwd_groups(k, tile.cvb * tile.vec, tile.threads), tiles,
                   tiles * (k * k + 2) * c, _cdiv(c, REDUCE_LANES) * (k * k + 2))


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = load_library(SOURCE)
        i64, vp, i32 = ctypes.c_int64, ctypes.c_void_p, ctypes.c_int
        lib.dw_conv_bn_silu.argtypes = [vp, vp, vp, vp, vp, i64, i64, i64, i64, i32, i32, i32, i32, i32,
                                        i32, i32, vp]
        lib.dw_conv_bn_silu.restype = ctypes.c_int
        lib.dw_bwd_tile.argtypes = [vp, vp, vp, vp, vp, vp, vp, i64, i64, i64, i64, i32, i32, i32, i32, i32, i32, i32,
                                    i32, vp]
        lib.dw_bwd_dx.argtypes = [vp, vp, vp, i64, i64, i64, i64, i32, i32, i32, i32, i32, i32, i32, vp]
        lib.dw_bwd_reduce.argtypes = [vp, i64, i64, i32, i32, i32, vp, vp, vp, vp]
        for fn in (lib.dw_bwd_tile, lib.dw_bwd_dx, lib.dw_bwd_reduce):
            fn.restype = ctypes.c_int
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
    return bsz, c, h, wd


def _check_kernel_input(x: torch.Tensor, w: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                        k: int) -> tuple[int, int, int, int]:
    """What the kernels take beyond :func:`_check_input`: a CUDA tensor of
    float32 or bfloat16 in channels_last memory, the parameters on its
    device, every extent below 2^31."""
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
    if max(h, wd, c) >= 2**31:
        raise ValueError(f"dw_conv_bn_silu: shape {tuple(x.shape)} has an extent of 2^31 or more")
    return bsz, c, h, wd


def _taps(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The (C, 1, k, k) weight as the kernels take it: (k, k, C) in ``dtype``."""
    return w.to(dtype)[:, 0].permute(1, 2, 0).contiguous()


def _kernel_fwd(x: torch.Tensor, w: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                k: int) -> torch.Tensor:
    """The kernel on a CUDA tensor, launched as :func:`plan` says."""
    bsz, c, h, wd = _check_kernel_input(x, w, a, b, k)
    if x.numel() == 0:
        return torch.empty_like(x, memory_format=torch.channels_last)  # nothing to launch
    pl = plan(tuple(x.shape), k, x.element_size(), x.data_ptr() % 16 == 0)
    wt = _taps(w, x.dtype)
    a, b = a.contiguous(), b.contiguous()
    y = torch.empty_like(x, memory_format=torch.channels_last)
    lib = _library()
    with torch.cuda.device(x.device):
        err = lib.dw_conv_bn_silu(
            x.data_ptr(), wt.data_ptr(), a.data_ptr(), b.data_ptr(), y.data_ptr(),
            bsz, h, wd, c, k, _DTYPE_CODE[x.dtype], pl.vec, pl.cvb, pl.runs, pl.rows_t, pl.tile_h,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err:
        raise RuntimeError(f"dw_conv_bn_silu launch failed with CUDA error {err}")
    LAUNCHES["dw_conv_bn_silu"] += 1
    return y


def _kernel_bwd(x: torch.Tensor, w: torch.Tensor, a: torch.Tensor, b: torch.Tensor, k: int, gy: torch.Tensor,
                needs: tuple[bool, bool, bool, bool] = (True,) * 4) -> tuple:
    """The backward's kernels on CUDA tensors, launched as :func:`plan_bwd`
    says: the tile pass, then the dx pass if x's gradient is needed and the
    reduce pass if any of w's, a's or b's is; ``(dx, dw, da, db)`` as
    :func:`dw_conv_bn_silu_bwd` returns them."""
    bsz, c, h, wd = _check_kernel_input(x, w, a, b, k)
    if gy.shape != x.shape or gy.dtype != x.dtype or gy.device != x.device:
        raise ValueError(f"dw_conv_bn_silu backward: the cotangent must match x, got {gy.dtype} "
                         f"{tuple(gy.shape)} on {gy.device} for {x.dtype} {tuple(x.shape)} on {x.device}")
    if not gy.is_contiguous(memory_format=torch.channels_last):
        gy = gy.contiguous(memory_format=torch.channels_last)
        COPIES["gy_channels_last"] += 1
    want_dx, want_w, want_ab = needs[0], needs[1], needs[2] or needs[3]
    f32 = dict(dtype=torch.float32, device=x.device)
    if x.numel() == 0:  # nothing to launch: the sums over no pixel are 0
        dwz = torch.zeros(w.shape, dtype=w.dtype, device=x.device)
        zero = torch.zeros(c, **f32)
        return (torch.empty_like(x, memory_format=torch.channels_last) if needs[0] else None,
                dwz if needs[1] else None, zero if needs[2] else None, zero.clone() if needs[3] else None)
    pb = plan_bwd(tuple(x.shape), k, x.element_size(), x.data_ptr() % 16 == 0 and gy.data_ptr() % 16 == 0)
    tl, dl = pb.tile, pb.dx
    wt = _taps(w, x.dtype)
    a, b = a.contiguous(), b.contiguous()
    flags = (_WANT_DX if want_dx else 0) | (_WANT_W if want_w else 0) | (_WANT_AB if want_ab else 0)
    dacc = torch.empty_like(x, dtype=torch.float32, memory_format=torch.channels_last) if want_dx else None
    ws = torch.empty(pb.workspace, **f32) if want_w or want_ab else None
    lib = _library()
    dx = dw = da = db = None
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.dw_bwd_tile(
            x.data_ptr(), wt.data_ptr(), a.data_ptr(), b.data_ptr(), gy.data_ptr(),
            dacc.data_ptr() if dacc is not None else None, ws.data_ptr() if ws is not None else None,
            bsz, h, wd, c, k, _DTYPE_CODE[x.dtype], tl.vec, tl.cvb, tl.runs, tl.rows_t, tl.tile_h, flags, stream)
        if err:
            raise RuntimeError(f"dw_bwd_tile launch failed with CUDA error {err}")
        BWD_LAUNCHES["dw_bwd_tile"] += 1
        if want_dx:
            dx = torch.empty_like(x, memory_format=torch.channels_last)
            err = lib.dw_bwd_dx(dacc.data_ptr(), wt.data_ptr(), dx.data_ptr(), bsz, h, wd, c, k,
                                _DTYPE_CODE[x.dtype], dl.vec, dl.cvb, dl.runs, dl.rows_t, dl.tile_h, stream)
            if err:
                raise RuntimeError(f"dw_bwd_dx launch failed with CUDA error {err}")
            BWD_LAUNCHES["dw_bwd_dx"] += 1
        if want_w or want_ab:
            dw32 = torch.empty((c, 1, k, k), **f32) if want_w else None
            da, db = (torch.empty(c, **f32), torch.empty(c, **f32)) if want_ab else (None, None)
            row0 = 0 if want_w else k * k
            nrows = (k * k if want_w else 0) + (2 if want_ab else 0)
            err = lib.dw_bwd_reduce(ws.data_ptr(), pb.tiles, c, k, row0, nrows,
                                    dw32.data_ptr() if want_w else None, da.data_ptr() if want_ab else None,
                                    db.data_ptr() if want_ab else None, stream)
            if err:
                raise RuntimeError(f"dw_bwd_reduce launch failed with CUDA error {err}")
            BWD_LAUNCHES["dw_bwd_reduce"] += 1
            dw = dw32.to(w.dtype) if want_w else None
    return dx, dw, da if needs[2] else None, db if needs[3] else None


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


def dw_conv_bn_silu_fwd(x: torch.Tensor, w: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                        k: int) -> torch.Tensor:
    """``silu(a * dwconv_kxk(x, w) + b)``: the kernel for a CUDA tensor, the
    plain version for a CPU tensor.  No gradient."""
    if x.device.type == "cuda":
        return _kernel_fwd(x, w, a, b, k)
    if x.device.type == "cpu":
        return dw_conv_bn_silu_plain(x, w, a, b, k)
    raise ValueError(f"dw_conv_bn_silu: unsupported device {x.device}")


def dw_conv_bn_silu_bwd(x: torch.Tensor, w: torch.Tensor, a: torch.Tensor, b: torch.Tensor, k: int,
                        gy: torch.Tensor, needs: tuple[bool, bool, bool, bool] = (True,) * 4) -> tuple:
    """``(dx, dw, da, db)`` of :func:`dw_conv_bn_silu` under the cotangent
    ``gy``, in plain torch and f32 as the module docstring states; an entry
    whose ``needs`` is False is None."""
    bsz, c, h, wd = _check_input(x, w, a, b, k)
    p = (k - 1) // 2
    xp = F.pad(x.permute(0, 2, 3, 1).float(), (0, 0, p, p, p, p))  # (B, H+2p, W+2p, C)
    wk = w.to(x.dtype).float()[:, 0]  # (C, k, k): the forward's rounding of w
    acc = torch.zeros((bsz, h, wd, c), dtype=torch.float32, device=x.device)
    for dy in range(k):
        for dx in range(k):
            acc = acc + xp[:, dy : dy + h, dx : dx + wd, :] * wk[:, dy, dx]
    z = acc * a + b
    sig = torch.sigmoid(z)
    dz = gy.permute(0, 2, 3, 1).float() * (sig * (1 + z * (1 - sig)))
    da = (dz * acc).sum(dim=(0, 1, 2)) if needs[2] else None
    db = dz.sum(dim=(0, 1, 2)) if needs[3] else None
    dacc = dz * a
    dx = dw = None
    if needs[0]:
        dp = F.pad(dacc, (0, 0, p, p, p, p))
        gx = torch.zeros_like(acc)
        for dy in range(k):
            for dx_ in range(k):
                gx = gx + dp[:, dy : dy + h, dx_ : dx_ + wd, :] * wk[:, k - 1 - dy, k - 1 - dx_]
        dx = gx.to(x.dtype).permute(0, 3, 1, 2)
    if needs[1]:
        taps = [(dacc * xp[:, dy : dy + h, dx_ : dx_ + wd, :]).sum(dim=(0, 1, 2)) for dy in range(k) for dx_ in range(k)]
        dw = torch.stack(taps, dim=1).reshape(c, 1, k, k).to(w.dtype)
    return dx, dw, da, db


def dw_conv_bn_silu_grad(x: torch.Tensor, w: torch.Tensor, a: torch.Tensor, b: torch.Tensor, k: int,
                         gy: torch.Tensor, needs: tuple[bool, bool, bool, bool] = (True,) * 4) -> tuple:
    """``(dx, dw, da, db)`` of :func:`dw_conv_bn_silu` under ``gy``: the
    kernels for a CUDA tensor, the plain version for a CPU tensor; an
    entry whose ``needs`` is False is None."""
    if x.device.type == "cuda":
        return _kernel_bwd(x, w, a, b, k, gy, needs)
    if x.device.type == "cpu":
        return dw_conv_bn_silu_bwd(x, w, a, b, k, gy, needs)
    raise ValueError(f"dw_conv_bn_silu: unsupported device {x.device}")


class DwConvBnSilu(torch.autograd.Function):
    """The fused op with the gradient of :func:`dw_conv_bn_silu_grad`;
    saves ``x``, ``w``, ``a`` and ``b``."""

    @staticmethod
    def forward(ctx, x, w, a, b, k: int):
        ctx.save_for_backward(x, w, a, b)
        ctx.k = k
        return dw_conv_bn_silu_fwd(x, w, a, b, k)

    @staticmethod
    def backward(ctx, gy):
        x, w, a, b = ctx.saved_tensors
        return (*dw_conv_bn_silu_grad(x, w, a, b, ctx.k, gy, tuple(ctx.needs_input_grad[:4])), None)


def dw_conv_bn_silu(x: torch.Tensor, w: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                    k: int) -> torch.Tensor:
    """``silu(a * dwconv_kxk(x, w) + b)``, differentiable in x, w, a and b:
    the kernel for a CUDA tensor, the plain version for a CPU tensor."""
    return DwConvBnSilu.apply(x, w, a, b, k)


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


def grad_within_tolerance(got: tuple, want: tuple, x_dtype: torch.dtype) -> tuple[bool, list[float]]:
    """The kernels-vs-plain bound stated in the module docstring, for
    ``(dx, dw, da, db)`` of the kernels and of :func:`dw_conv_bn_silu_bwd`
    on the same inputs of dtype ``x_dtype`` (None where not computed).
    Returns ``(ok, max_abs_err of each gradient)``."""
    ok, errs = True, []
    f32 = x_dtype == torch.float32
    for i, (g, p) in enumerate(zip(got, want)):
        if p is None:
            ok &= g is None
            errs.append(0.0)
            continue
        if i == 0:
            good, err = within_tolerance(g, p)
        else:
            err = (g.float() - p.float()).abs().max().item() if p.numel() else 0.0
            good = err <= (1e-5 if f32 else 1e-4) * (p.float().abs().max().item() if p.numel() else 0.0)
        ok &= good and g.dtype == p.dtype and g.shape == p.shape
        errs.append(err)
    return ok, errs
