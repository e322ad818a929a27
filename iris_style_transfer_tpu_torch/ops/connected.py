"""Connected components, the largest component and area opening on batches
of binary masks.

Counterpart of ``iris_style_transfer_tpu/ops/connected.py``, whose
labelling is min-label propagation inside a ``lax.while_loop`` (not a
Pallas kernel).  Here a CUDA tensor is labelled by the hand-written
union-find kernel of ``ops/csrc/connected.cu`` (three launches a call:
tile, seam, finalize), which can also count each label's pixels
(:func:`connected_components_with_areas`); a CPU tensor takes
:func:`connected_components_plain` (and ``_areas``' scatter).
Both give the converged labelling: int32 labels, 0 for background, and for
a foreground pixel 1 + the least per-image linear index of its component.
That equals the JAX loop's labels wherever the loop converges within its
``max_iters`` cap (``h + w`` sweeps by default), which this port does not
have: a long winding component, such as a serpentine, is labelled whole
here where the capped JAX loop leaves it in pieces (ROADMAP).

``connectivity`` follows skimage: 1 = 4-neighbourhood, 2 = 8-neighbourhood.
Every function takes a (B, H, W) batch; the JAX functions take one (H, W)
mask under ``vmap``.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .cuda_build import load_library

SOURCE = "connected.cu"
TILE_H, TILE_W = 32, 64  # connected.cu's kTH x kTW: the pixels one block labels in shared memory
KERNELS_PER_CALL = 3  # tile, seam, finalize
# kernel launches in this process: connected_components and
# connected_components_with_areas add KERNELS_PER_CALL per call on a CUDA
# tensor and nothing else touches it except callers resetting it
LAUNCHES = {"connected_components": 0}

_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = load_library(SOURCE)
        i64, vp = ctypes.c_int64, ctypes.c_void_p
        lib.connected_components.argtypes = [vp, vp, vp, vp, vp, i64, i64, i64, ctypes.c_int, vp]
        lib.connected_components.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(mask: torch.Tensor, connectivity: int) -> tuple[int, int, int]:
    if mask.dim() != 3:
        raise ValueError(f"connected_components: expected a (B, H, W) mask, got shape {tuple(mask.shape)}")
    if connectivity not in (1, 2):
        raise ValueError(f"connected_components: connectivity must be 1 or 2, got {connectivity}")
    b, h, w = mask.shape
    if h * w + 1 >= 2**31:
        raise ValueError(f"connected_components: an image of {h}x{w} pixels overflows the int32 labels")
    return b, h, w


def _kernel(mask: torch.Tensor, connectivity: int, with_areas: bool = False):
    """The labels, and with ``with_areas`` the (B, H * W + 1) pixel counts
    by label, from the kernel; returns (labels, areas or None)."""
    b, h, w = _check(mask, connectivity)
    m = (mask if mask.dtype == torch.bool else mask != 0).contiguous()
    dev = mask.device
    labels = torch.empty((b, h, w), dtype=torch.int32, device=dev)
    if m.numel() == 0:
        return labels, (torch.zeros((b, h * w + 1), dtype=torch.int32, device=dev) if with_areas else None)
    tiles = b * -(-h // TILE_H) * -(-w // TILE_W)
    if max(tiles, (m.numel() + 255) // 256) >= 2**31:
        raise ValueError(f"connected_components: {m.numel()} pixels need more than 2^31 - 1 blocks")
    areas = torch.empty((b, h * w + 1), dtype=torch.int32, device=dev) if with_areas else None
    # two bytes a tile: a seam linked one of its roots; it has foreground on
    # its first row or column; with areas, a bit a pixel: the tile roots
    flags = torch.empty(2 * tiles, dtype=torch.uint8, device=dev)
    rootbits = torch.empty(tiles * TILE_H * TILE_W // 32, dtype=torch.int32, device=dev) if with_areas else None
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.connected_components(m.data_ptr(), labels.data_ptr(), areas.data_ptr() if with_areas else None,
                                       rootbits.data_ptr() if with_areas else None, flags.data_ptr(), b, h, w,
                                       int(connectivity == 2), torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"connected_components launch failed with CUDA error {err}")
    LAUNCHES["connected_components"] += KERNELS_PER_CALL
    return labels, areas


def _neighbour_min(lab: torch.Tensor, big: int, connectivity: int) -> torch.Tensor:
    _, h, w = lab.shape
    pad = F.pad(lab, (1, 1, 1, 1), value=big)
    offs = [(-1, 0), (1, 0), (0, -1), (0, 1)]
    if connectivity == 2:
        offs += [(-1, -1), (-1, 1), (1, -1), (1, 1)]
    nm = lab
    for dy, dx in offs:
        nm = torch.minimum(nm, pad[:, 1 + dy:1 + dy + h, 1 + dx:1 + dx + w])
    return nm


def connected_components_plain(mask: torch.Tensor, connectivity: int = 2) -> torch.Tensor:
    """The plain torch labelling on any device: neighbour-min propagation
    as in JAX, plus hooking (each pixel lowers the label of its label's
    origin pixel to its neighbourhood minimum, a scatter-min) and pointer
    jumping (``lab <- lab[lab - 1]``), until a round changes nothing (one
    read back per round).  Labels only ever fall to the index of a pixel of
    the same component, so the fixed point is the converged labelling."""
    b, h, w = _check(mask, connectivity)
    n = h * w
    m = (mask if mask.dtype == torch.bool else mask != 0).reshape(b, n)
    big = n + 1
    idx = torch.arange(1, n + 1, dtype=torch.int32, device=mask.device)
    lab = torch.where(m, idx, big)
    while True:
        nm = _neighbour_min(lab.view(b, h, w), big, connectivity).reshape(b, n)
        ext = F.pad(lab, (0, 1), value=big)  # index n: background's origin
        ext.scatter_reduce_(1, (lab - 1).long(), nm, "amin")  # hooking
        ext[:, :n] = torch.minimum(ext[:, :n], nm)
        new = torch.where(m, ext.gather(1, (ext[:, :n] - 1).long()), big)  # pointer jumping
        if torch.equal(new, lab):
            return torch.where(m, lab, 0).view(b, h, w)
        lab = new


def connected_components(mask: torch.Tensor, connectivity: int = 2) -> torch.Tensor:
    """Label the components of each (B, H, W) mask: the kernel for a CUDA
    tensor, the plain version for a CPU tensor; int32 labels."""
    if mask.device.type == "cuda":
        return _kernel(mask, connectivity)[0]
    if mask.device.type == "cpu":
        return connected_components_plain(mask, connectivity)
    raise ValueError(f"connected_components: unsupported device {mask.device}")


def _areas(lab: torch.Tensor) -> torch.Tensor:
    """(B, H * W + 1) int32 pixel counts by label (the JAX scatter-add),
    with the background's entry 0 at 0."""
    b, h, w = lab.shape
    flat = lab.reshape(b, h * w).long()
    areas = torch.zeros((b, h * w + 1), dtype=torch.int32, device=lab.device)
    areas.scatter_add_(1, flat, torch.ones_like(flat, dtype=torch.int32))
    areas[:, 0] = 0
    return areas


def connected_components_with_areas(mask: torch.Tensor, connectivity: int = 2) -> tuple[torch.Tensor, torch.Tensor]:
    """(labels, areas): the labels of :func:`connected_components` and each
    label's pixel count, (B, H * W + 1) int32 indexed by label (entry 0, the
    background, is 0).  A CUDA tensor takes the kernel, which counts in its
    tile and finalize passes; a CPU tensor the plain labelling and a
    scatter-add."""
    if mask.device.type == "cuda":
        return _kernel(mask, connectivity, with_areas=True)
    if mask.device.type == "cpu":
        lab = connected_components_plain(mask, connectivity)
        return lab, _areas(lab)
    raise ValueError(f"connected_components: unsupported device {mask.device}")


def largest_component(mask: torch.Tensor, connectivity: int = 2) -> torch.Tensor:
    """(B, H, W) bool: each mask's largest component; on a tie the lowest
    label wins (``argmax``'s first maximum), and an empty mask stays empty."""
    lab, areas = connected_components_with_areas(mask, connectivity)
    best = areas.argmax(dim=1).to(torch.int32)  # int32, as the labels: no promotion of the compare
    return lab == torch.where(best > 0, best, -1)[:, None, None]  # -1: no label, so an empty mask stays empty


def area_opening(mask: torch.Tensor, area_threshold: int = 500, connectivity: int = 2) -> torch.Tensor:
    """Remove the components smaller than ``area_threshold`` pixels from each
    (B, H, W) mask (skimage's ``area_opening`` on binary masks)."""
    lab, areas = connected_components_with_areas(mask, connectivity)
    b, h, w = lab.shape
    keep = areas.gather(1, lab.reshape(b, h * w).long()).view(b, h, w) >= area_threshold
    return mask.bool() & keep  # the labels are > 0 exactly where the mask is set
