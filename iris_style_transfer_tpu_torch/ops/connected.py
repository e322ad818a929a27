"""Connected components, the largest component and area opening on batches
of binary masks.

Counterpart of ``iris_style_transfer_tpu/ops/connected.py``, whose
labelling is min-label propagation inside a ``lax.while_loop`` (not a
Pallas kernel).  Here a CUDA tensor is labelled by the hand-written
union-find kernel of ``ops/csrc/connected.cu`` (three launches a call:
init, merge, finalize); a CPU tensor takes :func:`connected_components_plain`.
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
KERNELS_PER_CALL = 3  # init, merge, finalize
# kernel launches in this process: connected_components adds
# KERNELS_PER_CALL per call on a CUDA tensor and nothing else touches it
# except callers resetting it
LAUNCHES = {"connected_components": 0}

_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = load_library(SOURCE)
        i64, vp = ctypes.c_int64, ctypes.c_void_p
        lib.connected_components.argtypes = [vp, vp, i64, i64, i64, ctypes.c_int, vp]
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


def _kernel(mask: torch.Tensor, connectivity: int) -> torch.Tensor:
    b, h, w = _check(mask, connectivity)
    m = (mask if mask.dtype == torch.bool else mask != 0).contiguous()
    labels = torch.empty((b, h, w), dtype=torch.int32, device=mask.device)
    if m.numel() == 0:
        return labels
    if (m.numel() + 255) // 256 >= 2**31:
        raise ValueError(f"connected_components: {m.numel()} pixels need more than 2^31 - 1 blocks")
    lib = _library()
    with torch.cuda.device(mask.device):
        err = lib.connected_components(m.data_ptr(), labels.data_ptr(), b, h, w, int(connectivity == 2),
                                       torch.cuda.current_stream(mask.device).cuda_stream)
    if err:
        raise RuntimeError(f"connected_components launch failed with CUDA error {err}")
    LAUNCHES["connected_components"] += KERNELS_PER_CALL
    return labels


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
        return _kernel(mask, connectivity)
    if mask.device.type == "cpu":
        return connected_components_plain(mask, connectivity)
    raise ValueError(f"connected_components: unsupported device {mask.device}")


def _areas(lab: torch.Tensor) -> torch.Tensor:
    """(B, H * W + 2) int32 pixel counts per label (the JAX scatter-add)."""
    b, h, w = lab.shape
    flat = lab.reshape(b, h * w).long()
    areas = torch.zeros((b, h * w + 2), dtype=torch.int32, device=lab.device)
    return areas.scatter_add_(1, flat, torch.ones_like(flat, dtype=torch.int32))


def largest_component(mask: torch.Tensor, connectivity: int = 2) -> torch.Tensor:
    """(B, H, W) bool: each mask's largest component; on a tie the lowest
    label wins (``argmax``'s first maximum), and an empty mask stays empty."""
    lab = connected_components(mask, connectivity)
    areas = _areas(lab)
    areas[:, 0] = 0  # background
    best = areas.argmax(dim=1)[:, None, None]
    return (lab == best) & (best > 0)


def area_opening(mask: torch.Tensor, area_threshold: int = 500, connectivity: int = 2) -> torch.Tensor:
    """Remove the components smaller than ``area_threshold`` pixels from each
    (B, H, W) mask (skimage's ``area_opening`` on binary masks)."""
    lab = connected_components(mask, connectivity)
    b, h, w = lab.shape
    keep = _areas(lab).gather(1, lab.reshape(b, h * w).long()).view(b, h, w) >= area_threshold
    return mask.bool() & keep & (lab > 0)
