"""Iris mask, bounding box, crop and composite, in plain float32 PyTorch.

The mask is RITnet's iris class (2) where the frame is at or below the
glint threshold; the box is the inclusive extent of the masked frame's
nonzero pixels (the whole frame when there are none); the crop resizes
the box to 224x224 by bilinear sampling at half-pixel centres, sample
coordinates clamped into the box; the composite resizes the stylized
iris (RGB -> gray with ITU-R 601-2 weights) back over the box the same
way and blends it in under the mask.  Frames are (B, H, W, 1).
"""

from __future__ import annotations

import torch

from .precision import F32, Precision

IRIS = 2
GRAY = (0.2989, 0.587, 0.114)


def iris_mask(labels: torch.Tensor, frames: torch.Tensor, glint: float = 0.8) -> torch.Tensor:
    return (labels == IRIS) & (frames[..., 0] <= glint)


def bbox(mask: torch.Tensor) -> torch.Tensor:
    """(B, H, W) bool -> (B, 4) [r_min, c_min, r_max, c_max], int64."""
    out = []
    for m in mask:
        rows = torch.nonzero(m.any(1))[:, 0]
        cols = torch.nonzero(m.any(0))[:, 0]
        if rows.numel() == 0:
            out.append(torch.tensor([0, 0, m.shape[0] - 1, m.shape[1] - 1], device=m.device))
        else:
            out.append(torch.stack([rows[0], cols[0], rows[-1], cols[-1]]))
    return torch.stack(out).long()


def _bilinear(img: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor, prec: Precision) -> torch.Tensor:
    """Sample (H, W, C) at the grid ys (oh,) x xs (ow,), coordinates
    clipped into the image, by gathering the four neighbours."""
    h, w, _ = img.shape
    ys = ys.clamp(0, h - 1)
    xs = xs.clamp(0, w - 1)
    y0, x0 = torch.floor(ys), torch.floor(xs)
    wy, wx = prec.q("f32", (ys - y0)[:, None, None]), prec.q("f32", (xs - x0)[None, :, None])
    y0i, x0i = y0.long(), x0.long()
    y1i, x1i = (y0i + 1).clamp_max(h - 1), (x0i + 1).clamp_max(w - 1)
    im = prec.q("f32", img)
    top = im[y0i][:, x0i] * (1 - wx) + im[y0i][:, x1i] * wx
    bot = im[y1i][:, x0i] * (1 - wx) + im[y1i][:, x1i] * wx
    return top * (1 - wy) + bot * wy


def crop(frames: torch.Tensor, boxes: torch.Tensor, size=(224, 224), prec: Precision = F32) -> torch.Tensor:
    """(B, H, W, C) -> (B, *size, C): each box resized to ``size``."""
    out = []
    for img, bb in zip(frames.float(), boxes.float()):
        r0, c0, r1, c1 = bb
        oy = torch.arange(size[0], device=img.device, dtype=torch.float32)
        ox = torch.arange(size[1], device=img.device, dtype=torch.float32)
        ys = torch.minimum(torch.maximum((oy + 0.5) * ((r1 - r0 + 1) / size[0]) - 0.5 + r0, r0), r1)
        xs = torch.minimum(torch.maximum((ox + 0.5) * ((c1 - c0 + 1) / size[1]) - 0.5 + c0, c0), c1)
        out.append(_bilinear(img, ys, xs, prec))
    return torch.stack(out)


def composite(frames: torch.Tensor, stylized_nchw: torch.Tensor, masks: torch.Tensor, boxes: torch.Tensor,
              prec: Precision = F32) -> torch.Tensor:
    """Frames (B, H, W, 1) with the stylized irises (B, 3, h, w) pasted
    back over their boxes under the masks (B, H, W)."""
    g = torch.tensor(GRAY, device=frames.device)
    gray = (prec.q("f32", stylized_nchw.float().permute(0, 2, 3, 1)) * prec.q("f32", g)).sum(-1, keepdim=True)
    out = []
    for fr, st, m, bb in zip(frames.float(), gray, masks, boxes.float()):
        h, w = fr.shape[:2]
        ph, pw = st.shape[:2]
        r0, c0, r1, c1 = bb
        fy = torch.arange(h, device=fr.device, dtype=torch.float32)
        fx = torch.arange(w, device=fr.device, dtype=torch.float32)
        ys = (fy - r0 + 0.5) * (ph / (r1 - r0 + 1)) - 0.5
        xs = (fx - c0 + 0.5) * (pw / (c1 - c0 + 1)) - 0.5
        pasted = _bilinear(st, ys, xs, prec)
        inside = ((fy >= r0) & (fy <= r1))[:, None] & ((fx >= c0) & (fx <= c1))[None, :]
        mm = (m & inside).float()[..., None]
        out.append(fr * (1 - mm) + pasted * mm)
    return torch.stack(out)
