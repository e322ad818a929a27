"""Moment-based ellipse fitting and the 19-d eye landmarks, batched.

Counterpart of ``iris_style_transfer_tpu/ops/ellipse.py`` (reference
``gaze_estimators.py:55-178``, which runs OpenCV ``findContours`` +
``fitEllipse`` per image on the host).  Here the ellipse comes from the
filled mask's second moments, for a whole batch at once on the mask's
device: the full axes of a solid ellipse are ``4 * sqrt(eigenvalue)`` of
its covariance.  Every function takes a leading batch axis B and returns
one row per image; a failed fit (too few pixels, empty mask) gives zeros,
as the reference's None -> 0.  ``select_largest=True`` fits only each
mask's largest connected component (``ops/connected.py``, 8-connected).
"""

from __future__ import annotations

import torch

from .connected import largest_component


def fit_ellipse_mask(mask: torch.Tensor, select_largest: bool = False, min_pixels: int = 5) -> torch.Tensor:
    """Fit an ellipse to each boolean (B, H, W) mask by image moments.

    Returns (B, 6) float32 rows ``[cx, cy, major, minor, angle_deg,
    valid]``: ``cx`` is the column coordinate (cv2's), ``angle_deg`` in
    [0, 180) the rotation of the first axis from the x-axis."""
    if select_largest:
        mask = largest_component(mask)
    m = mask.float()
    _, h, w = m.shape
    ys = torch.arange(h, dtype=torch.float32, device=m.device)[:, None]
    xs = torch.arange(w, dtype=torch.float32, device=m.device)[None, :]
    area = m.sum(dim=(1, 2))
    valid = area >= min_pixels
    safe_area = torch.clamp_min(area, 1.0)
    cx = (m * xs).sum(dim=(1, 2)) / safe_area
    cy = (m * ys).sum(dim=(1, 2)) / safe_area
    dx = xs[None] - cx[:, None, None]
    dy = ys[None] - cy[:, None, None]
    mu20 = (m * dx * dx).sum(dim=(1, 2)) / safe_area
    mu02 = (m * dy * dy).sum(dim=(1, 2)) / safe_area
    mu11 = (m * dx * dy).sum(dim=(1, 2)) / safe_area
    tr = mu20 + mu02
    det_term = torch.sqrt(torch.clamp_min(((mu20 - mu02) / 2.0) ** 2 + mu11**2, 0.0))
    lam1 = tr / 2.0 + det_term  # larger eigenvalue
    lam2 = torch.clamp_min(tr / 2.0 - det_term, 0.0)
    major = 4.0 * torch.sqrt(torch.clamp_min(lam1, 0.0))
    minor = 4.0 * torch.sqrt(lam2)
    angle_deg = torch.remainder(torch.rad2deg(0.5 * torch.atan2(2.0 * mu11, mu20 - mu02)), 180.0)
    out = torch.stack([cx, cy, major, minor, angle_deg, torch.ones_like(cx)], dim=1)
    return torch.where(valid[:, None], out, 0.0)


def eye_corners(mask: torch.Tensor) -> torch.Tensor:
    """Extents of each (B, H, W) sclera mask: (B, 5) rows ``[left, right,
    bottom, top, valid]`` (min/max column, min/max row; the reference's
    "bottom" is the smaller row index); zeros for an empty mask."""
    m = mask.bool()
    _, h, w = m.shape
    rows = m.any(dim=2)
    cols = m.any(dim=1)
    ridx = torch.arange(h, dtype=torch.float32, device=m.device)
    cidx = torch.arange(w, dtype=torch.float32, device=m.device)
    left = torch.where(cols, cidx, float(w)).amin(dim=1)
    right = torch.where(cols, cidx, -1.0).amax(dim=1)
    bottom = torch.where(rows, ridx, float(h)).amin(dim=1)
    top = torch.where(rows, ridx, -1.0).amax(dim=1)
    out = torch.stack([left, right, bottom, top, torch.ones_like(left)], dim=1)
    return torch.where(rows.any(dim=1)[:, None], out, 0.0)


def extract_eye_landmarks(segmentation: torch.Tensor, epsilon: float = 1e-6,
                          select_largest: bool = False) -> torch.Tensor:
    """(B, H, W) class maps (0 bg, 1 sclera, 2 iris, 3 pupil) -> (B, 19)
    float32: pupil ellipse (5), iris ellipse (5), eye corners (4), eye
    width, height and aspect ratio (3), normalized pupil position (2).
    Unavailable features are 0."""
    p = fit_ellipse_mask(segmentation == 3, select_largest)
    i = fit_ellipse_mask(segmentation == 2, select_largest)
    c = eye_corners(segmentation == 1)

    left, right, bottom, top, c_valid = c.unbind(dim=1)
    eye_width = (right - left) * c_valid
    eye_height = (top - bottom) * c_valid
    ear = torch.where(c_valid > 0, eye_height / (eye_width + epsilon), 0.0)
    both = (p[:, 5] > 0) & (c_valid > 0)
    norm_px = torch.where(both, (p[:, 0] - (left + right) / 2.0) / (eye_width + epsilon), 0.0)
    norm_py = torch.where(both, (p[:, 1] - (bottom + top) / 2.0) / (eye_height + epsilon), 0.0)
    return torch.cat(
        [p[:, :5], i[:, :5], c[:, :4],
         torch.stack([eye_width, eye_height, ear, norm_px, norm_py], dim=1)],
        dim=1,
    ).float()
