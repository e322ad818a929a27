"""The two gaze estimators, in plain float32 PyTorch.

Estimator 1 reads 19 eye landmarks off a segmentation map: the pupil's
and the iris's ellipses (centre column and row, full major and minor
axes, angle in [0, 180) degrees) from the second moments of the filled
class masks (a solid ellipse's full axes are 4 sqrt(eigenvalue); fewer
than 5 pixels give zeros), the sclera's extents (left, right, bottom,
top), the eye's width, height and their ratio, and the pupil centre
normalised by the eye box.  Estimator 2 reads ResNet50's 2048 features.
Each then runs an MLP (ReLU, 64, 64, 3) and normalises the output.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .precision import F32, Precision


def _ellipse(m: torch.Tensor) -> torch.Tensor:
    """(B, H, W) bool -> (B, 6) [cx, cy, major, minor, angle, valid],
    zeros when under 5 pixels."""
    m = m.double()
    _, h, w = m.shape
    ys = torch.arange(h, dtype=torch.float64, device=m.device).view(1, h, 1)
    xs = torch.arange(w, dtype=torch.float64, device=m.device).view(1, 1, w)
    n = m.sum((1, 2))
    a = n.clamp_min(1)
    cx, cy = (m * xs).sum((1, 2)) / a, (m * ys).sum((1, 2)) / a
    dx, dy = xs - cx.view(-1, 1, 1), ys - cy.view(-1, 1, 1)
    c20, c02, c11 = (m * dx * dx).sum((1, 2)) / a, (m * dy * dy).sum((1, 2)) / a, (m * dx * dy).sum((1, 2)) / a
    half = torch.sqrt(((c20 - c02) / 2) ** 2 + c11**2)
    l1, l2 = (c20 + c02) / 2 + half, ((c20 + c02) / 2 - half).clamp_min(0)
    ang = torch.remainder(torch.rad2deg(0.5 * torch.atan2(2 * c11, c20 - c02)), 180.0)
    out = torch.stack([cx, cy, 4 * torch.sqrt(l1.clamp_min(0)), 4 * torch.sqrt(l2), ang, torch.ones_like(cx)], 1)
    return torch.where((n >= 5).view(-1, 1), out, 0.0).float()


def landmarks(seg: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """(B, H, W) labels (0 bg, 1 sclera, 2 iris, 3 pupil) -> (B, 19)."""
    pupil, iris = _ellipse(seg == 3), _ellipse(seg == 2)
    scl = seg == 1
    _, h, w = scl.shape
    rows, cols = scl.any(2), scl.any(1)
    ok = rows.any(1)
    ci = torch.arange(w, device=seg.device, dtype=torch.float32)
    ri = torch.arange(h, device=seg.device, dtype=torch.float32)
    left = torch.where(cols, ci, float(w)).amin(1)
    right = torch.where(cols, ci, -1.0).amax(1)
    bottom = torch.where(rows, ri, float(h)).amin(1)
    top = torch.where(rows, ri, -1.0).amax(1)
    corners = torch.where(ok.view(-1, 1), torch.stack([left, right, bottom, top], 1), 0.0)
    left, right, bottom, top = corners.unbind(1)
    ew, eh = right - left, top - bottom
    ratio = torch.where(ok, eh / (ew + eps), 0.0)
    both = ok & (pupil[:, 5] > 0)
    px = torch.where(both, (pupil[:, 0] - (left + right) / 2) / (ew + eps), 0.0)
    py = torch.where(both, (pupil[:, 1] - (bottom + top) / 2) / (eh + eps), 0.0)
    return torch.cat([pupil[:, :5], iris[:, :5], corners, torch.stack([ew, eh, ratio, px, py], 1)], 1)


def mlp(p: dict, x: torch.Tensor, prec: Precision = F32) -> torch.Tensor:
    """The estimators' head: unit 3-d gaze vectors."""
    for k in ("fc0", "fc1", "fc2"):
        x = F.linear(prec.q("f32", x), prec.q("f32", p[k]["w"].float()), p[k]["b"].float())
        if k != "fc2":
            x = torch.relu(x)
    return x / x.norm(dim=1, keepdim=True)
