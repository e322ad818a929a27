"""Static-shape image primitives used by the 2019 privacy path.

Counterpart of ``iris_style_transfer_tpu/ops/image.py``.  Frames, masks and
iris crops stay channel-last ``(..., H, W, C)`` exactly as in the JAX
package, so the two are compared like with like; the conv models take
NCHW and the workload permutes at that boundary (a free view for
channels_last memory).  Crop-and-resize and paste are batched separable
resamples: two 2-tap interpolation matrices per image, applied as one
einsum over the batch.  The training augmentations (rotation, perspective)
warp one (H, W, C) image by an inverse homography, nearest or bilinear,
with their random parameters drawn from a ``torch.Generator``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

# torchvision rgb_to_grayscale / ITU-R 601-2 luma weights
_GRAY_WEIGHTS = (0.2989, 0.587, 0.114)


def to_unit_float(x: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """uint8 / uint16 image -> float in [0,1]; float images pass through."""
    if x.dtype == torch.uint8:
        return x.to(dtype) / 255.0
    if x.dtype == torch.uint16:
        return x.to(dtype) / 65535.0
    return x


def quantize_u8(a: np.ndarray) -> np.ndarray:
    """Host-side inverse of :func:`to_unit_float` for u8-quantized images."""
    if a.dtype == np.uint8:
        return a
    return np.round(a * 255.0).astype(np.uint8)


def quantize_u16(x: torch.Tensor) -> torch.Tensor:
    """[0,1] float -> uint16 (65536 levels, max error 7.6e-6)."""
    return torch.round(x.clamp(0.0, 1.0) * 65535.0).to(torch.uint16)


def pack_mask_bits(m: torch.Tensor) -> torch.Tensor:
    """(..., H, W, 1) bool -> (..., H, W//8, 1) uint8, LSB-first along W."""
    *lead, h, w, c = m.shape
    bits = m.to(torch.uint8).reshape(*lead, h, w // 8, 8, c)
    weights = (1 << torch.arange(8, device=m.device, dtype=torch.uint8)).reshape(8, 1)
    return (bits * weights).sum(dim=-2).to(torch.uint8)


def unpack_mask_bits(p: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_mask_bits`: (..., H, W8, 1) u8 -> bool."""
    *lead, h, w8, c = p.shape
    shifts = torch.arange(8, device=p.device, dtype=torch.uint8)
    bits = (p[..., :, None, :] >> shifts[None, :, None]) & 1
    return bits.reshape(*lead, h, w8 * 8, c).to(torch.bool)


def pack_labels2(seg: np.ndarray) -> np.ndarray:
    """Host-side: (..., H, W) class labels < 4 -> (..., H, W//4) uint8, 2
    bits per label LSB-first along W; :func:`unpack_labels2` inverts."""
    *lead, h, w = seg.shape
    if w % 4:
        raise ValueError(f"pack_labels2 needs a width divisible by 4, got {w}")
    if seg.max() >= 4:
        raise ValueError(f"pack_labels2 got a label >= 4 (max {seg.max()})")
    quads = seg.astype(np.uint8).reshape(*lead, h, w // 4, 4)
    weights = np.uint8(1) << (2 * np.arange(4, dtype=np.uint8))
    return (quads * weights).sum(axis=-1).astype(np.uint8)


def unpack_labels2(p: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_labels2`: (..., H, W4) u8 -> (..., H, 4*W4)."""
    *lead, h, w4 = p.shape
    shifts = 2 * torch.arange(4, device=p.device, dtype=torch.uint8)
    quads = (p[..., :, None] >> shifts) & 3
    return quads.reshape(*lead, h, w4 * 4)


def as_label_map(gt: torch.Tensor, width: int) -> torch.Tensor:
    """Raw (..., H, W) label map, or a 2-bit packed (..., H, W//4) one."""
    if gt.shape[-1] * 4 == width:
        return unpack_labels2(gt)
    return gt


def as_bool_mask(m: torch.Tensor) -> torch.Tensor:
    """Bool/float mask, or a bit-packed u8 one."""
    if m.dtype == torch.uint8:
        return unpack_mask_bits(m)
    return m.to(torch.bool)


@functools.lru_cache(maxsize=8)
def _imagenet_consts(device: torch.device, dtype: torch.dtype):
    # built once per (device, dtype): a host->device copy inside the NST
    # loop would synchronize every closure
    shape = (1, 3, 1, 1)
    mean = torch.tensor(IMAGENET_MEAN, dtype=dtype).reshape(shape).to(device)
    std = torch.tensor(IMAGENET_STD, dtype=dtype).reshape(shape).to(device)
    return mean, std


def imagenet_normalize(x: torch.Tensor) -> torch.Tensor:
    """(x - mean) / std over the channel axis of an NCHW batch (C == 3);
    the conv models apply it inside their forward, as the JAX package does
    over its trailing axis."""
    mean, std = _imagenet_consts(x.device, x.dtype)
    return (x - mean) / std


def rgb_to_grayscale(x: torch.Tensor, keepdims: bool = True) -> torch.Tensor:
    """Channel-last RGB -> grayscale with torchvision weights."""
    w = torch.tensor(_GRAY_WEIGHTS, dtype=x.dtype).to(x.device)
    y = torch.tensordot(x, w, dims=([-1], [0]))
    return y[..., None] if keepdims else y


def gray_to_rgb(x: torch.Tensor) -> torch.Tensor:
    """(..., H, W, 1) -> (..., H, W, 3)."""
    return x.repeat_interleave(3, dim=-1)


@functools.lru_cache(maxsize=4)
def _gamma_table(gamma: float) -> np.ndarray:
    # the reference's LUT, 255*(linspace(0,1,256)**g) truncated to uint8
    return (255.0 * np.linspace(0.0, 1.0, 256) ** gamma).astype(np.uint8).astype(np.float32)


def gamma_lut(x: torch.Tensor, gamma: float = 0.8) -> torch.Tensor:
    """RITnet gamma LUT on a float image in [0,1]: quantize to u8, look
    the level up in the reference's 256-entry table, return float in [0,1]."""
    u = torch.round(x.clamp(0.0, 1.0) * 255.0).to(torch.int64)
    table = torch.from_numpy(_gamma_table(float(gamma))).to(x.device, x.dtype)
    return table[u] / 255.0


def pad_height(x: torch.Tensor, top: int, bottom: int, value: float = 0.0) -> torch.Tensor:
    """Pad the H axis of channel-last (..., H, W, C) images; the B7 shell
    pads 400 -> 416 rows with (8, 8)."""
    return torch.nn.functional.pad(x, (0, 0, 0, 0, top, bottom), value=value)


def resize_bilinear(x: torch.Tensor, size: tuple[int, int], antialias: bool = True) -> torch.Tensor:
    """Bilinear resize of channel-last (..., H, W, C) images to (...,
    size[0], size[1], C): half-pixel centres, and with ``antialias`` a
    triangle filter widened by the scale when shrinking, as
    ``jax.image.resize(..., "bilinear")`` and torchvision's ``Resize`` do."""
    *lead, h, w, c = x.shape
    y = x.reshape(-1, h, w, c).permute(0, 3, 1, 2).float()
    y = torch.nn.functional.interpolate(y, size=tuple(size), mode="bilinear", align_corners=False,
                                        antialias=antialias)
    return y.permute(0, 2, 3, 1).reshape(*lead, size[0], size[1], c).to(x.dtype)


def nonzero_bbox(mask: torch.Tensor) -> torch.Tensor:
    """Batched inclusive bbox ``[r_min, c_min, r_max, c_max]`` (int32) of the
    nonzero extent of (B, H, W) masks; an empty mask gives the full image."""
    m = mask if mask.dtype == torch.bool else mask != 0
    _, h, w = m.shape
    rows = m.any(dim=2)
    cols = m.any(dim=1)
    ridx = torch.arange(h, device=m.device, dtype=torch.int32)
    cidx = torch.arange(w, device=m.device, dtype=torch.int32)
    any_nz = rows.any(dim=1)
    r_min = torch.where(rows, ridx, h).amin(dim=1)
    r_max = torch.where(rows, ridx, -1).amax(dim=1)
    c_min = torch.where(cols, cidx, w).amin(dim=1)
    c_max = torch.where(cols, cidx, -1).amax(dim=1)
    r_min = torch.where(any_nz, r_min, 0)
    c_min = torch.where(any_nz, c_min, 0)
    r_max = torch.where(any_nz, r_max, h - 1)
    c_max = torch.where(any_nz, c_max, w - 1)
    return torch.stack([r_min, c_min, r_max, c_max], dim=1).to(torch.int32)


def _axis_weights(coords: torch.Tensor, src_len: int) -> torch.Tensor:
    """(B, out) float sample coords -> (B, out, src) two-tap bilinear weights
    (clip into [0, src-1] before floor; +1 neighbour clipped after)."""
    c = coords.float().clamp(0.0, src_len - 1.0)
    c0 = torch.floor(c)
    w1 = (c - c0)[..., None]
    i0 = c0.to(torch.int32)[..., None]
    i1 = torch.clamp_max(i0 + 1, src_len - 1)
    cols = torch.arange(src_len, device=c.device, dtype=torch.int32)
    return (cols == i0) * (1.0 - w1) + (cols == i1) * w1


def _separable_resample(img: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """Sample (B, H, W, C) at per-image axis-aligned grids ys (B, oh) x
    xs (B, ow) via two interpolation matrices."""
    _, h, w, _ = img.shape
    wy = _axis_weights(ys, h)
    wx = _axis_weights(xs, w)
    out = torch.einsum("boh,bhwc,bpw->bopc", wy, img.float(), wx)
    return out.to(img.dtype)


def crop_and_resize(img: torch.Tensor, bbox: torch.Tensor, out_size: tuple[int, int]) -> torch.Tensor:
    """Crop each (H, W, C) image of a batch to its inclusive ``bbox`` (B, 4)
    and resize to ``out_size`` with half-pixel bilinear sampling."""
    bb = bbox.to(img.dtype)
    r_min, c_min, r_max, c_max = bb[:, 0:1], bb[:, 1:2], bb[:, 2:3], bb[:, 3:4]
    crop_h = r_max - r_min + 1
    crop_w = c_max - c_min + 1
    oh, ow = out_size
    ar_h = torch.arange(oh, device=img.device, dtype=img.dtype)[None]
    ar_w = torch.arange(ow, device=img.device, dtype=img.dtype)[None]
    ys = (ar_h + 0.5) * (crop_h / oh) - 0.5 + r_min
    xs = (ar_w + 0.5) * (crop_w / ow) - 0.5 + c_min
    # clamp into the crop so edges replicate exactly like crop-then-resize
    ys = torch.minimum(torch.maximum(ys, r_min), r_max)
    xs = torch.minimum(torch.maximum(xs, c_min), c_max)
    return _separable_resample(img, ys, xs)


def paste_resized(
    frame_shape: tuple[int, int], patch: torch.Tensor, bbox: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Resize each patch (B, h, w, C) into its inclusive ``bbox`` of an
    (H, W) frame.  Returns ``(pasted (B, H, W, C), inside (B, H, W, 1))``."""
    fh, fw = frame_shape
    bb = bbox.to(patch.dtype)
    r_min, c_min, r_max, c_max = bb[:, 0:1], bb[:, 1:2], bb[:, 2:3], bb[:, 3:4]
    crop_h = r_max - r_min + 1
    crop_w = c_max - c_min + 1
    _, ph, pw, _ = patch.shape
    fy = torch.arange(fh, device=patch.device, dtype=patch.dtype)[None]
    fx = torch.arange(fw, device=patch.device, dtype=patch.dtype)[None]
    ys = (fy - r_min + 0.5) * (ph / crop_h) - 0.5
    xs = (fx - c_min + 0.5) * (pw / crop_w) - 0.5
    sampled = _separable_resample(patch, ys, xs)
    bi = bbox.to(torch.int32)
    ri = torch.arange(fh, device=patch.device, dtype=torch.int32)[None, :, None]
    ci = torch.arange(fw, device=patch.device, dtype=torch.int32)[None, None, :]
    inside = (
        (ri >= bi[:, 0, None, None])
        & (ri <= bi[:, 2, None, None])
        & (ci >= bi[:, 1, None, None])
        & (ci <= bi[:, 3, None, None])
    )[..., None]
    return sampled * inside, inside


def composite_iris(
    frame: torch.Tensor, stylized: torch.Tensor, iris_mask: torch.Tensor, bbox: torch.Tensor
) -> torch.Tensor:
    """Replace the iris region of each frame (B, H, W, 1) with ``stylized``
    (B, ph, pw, 1) resized back into ``bbox`` and gated by ``iris_mask``:
    ``frame * (1 - m) + resize(stylized) * m``."""
    pasted, inside = paste_resized(frame.shape[1:3], stylized, bbox)
    m = iris_mask.to(frame.dtype) * inside.to(frame.dtype)
    return frame * (1.0 - m) + pasted * m


# ---------------------------------------------------------------------------
# Geometric augmentation (rotation / perspective), as torchvision's
# RandomRotation / RandomPerspective; one (H, W, C) image at a time.
# ---------------------------------------------------------------------------


def _bilinear_gather(img: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """Sample img (H, W, C) at float coords (out_h, out_w), edge-replicated:
    coords are clamped into [0, dim-1] before the floor."""
    h, w, _ = img.shape
    ys = ys.clamp(0.0, h - 1.0)
    xs = xs.clamp(0.0, w - 1.0)
    y0, x0 = torch.floor(ys), torch.floor(xs)
    wy, wx = (ys - y0)[..., None], (xs - x0)[..., None]
    y0i, x0i = y0.long(), x0.long()
    y1i, x1i = torch.clamp_max(y0i + 1, h - 1), torch.clamp_max(x0i + 1, w - 1)
    top = img[y0i, x0i] * (1 - wx) + img[y0i, x1i] * wx
    bot = img[y1i, x0i] * (1 - wx) + img[y1i, x1i] * wx
    return top * (1 - wy) + bot * wy


def _warp(img: torch.Tensor, inv_coeffs: torch.Tensor, mode: str, fill: float = 0.0) -> torch.Tensor:
    """Warp (H, W, C) by the inverse homography ``inv_coeffs`` (8,) that maps
    output pixel coords to input ones: x_src = (a x + b y + c) / (g x + h y
    + 1), y_src = (d x + e y + f) / (g x + h y + 1); ``fill`` outside."""
    h, w, _ = img.shape
    a, b, c, d, e, f, g, hh = inv_coeffs.to(img.dtype).unbind()
    ys = torch.arange(h, device=img.device, dtype=img.dtype)[:, None].expand(h, w)
    xs = torch.arange(w, device=img.device, dtype=img.dtype)[None, :].expand(h, w)
    denom = g * xs + hh * ys + 1.0
    xsrc = (a * xs + b * ys + c) / denom
    ysrc = (d * xs + e * ys + f) / denom
    if mode == "nearest":
        xi, yi = torch.round(xsrc).long(), torch.round(ysrc).long()
        valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        out = img[yi.clamp(0, h - 1), xi.clamp(0, w - 1)]
    elif mode == "bilinear":
        valid = (xsrc >= -0.5) & (xsrc <= w - 0.5) & (ysrc >= -0.5) & (ysrc <= h - 0.5)
        out = _bilinear_gather(img, ysrc, xsrc)
    else:
        raise ValueError(f"_warp: mode must be 'nearest' or 'bilinear', got {mode!r}")
    return torch.where(valid[..., None], out, fill)


def rotate(img: torch.Tensor, angle_deg: torch.Tensor | float, mode: str = "nearest") -> torch.Tensor:
    """Rotate (H, W, C) about its centre by ``angle_deg`` counterclockwise
    (torchvision's convention), same size, fill 0."""
    h, w, _ = img.shape
    theta = torch.as_tensor(angle_deg, dtype=torch.float32, device=img.device) * (torch.pi / 180.0)
    cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
    cos, sin = torch.cos(theta), torch.sin(theta)
    zero = torch.zeros_like(cos)
    coeffs = torch.stack([cos, -sin, -cos * cx + sin * cy + cx,
                          sin, cos, -sin * cx - cos * cy + cy, zero, zero])
    return _warp(img, coeffs, mode)


def _perspective_coeffs(startpoints: torch.Tensor, endpoints: torch.Tensor) -> torch.Tensor:
    """The homography (8,) that maps ``endpoints`` to ``startpoints``
    ((4, 2) arrays of (x, y)), the inverse warp used when sampling."""
    xe, ye = endpoints[:, 0], endpoints[:, 1]
    xs, ys = startpoints[:, 0], startpoints[:, 1]
    zeros, ones = torch.zeros_like(xe), torch.ones_like(xe)
    rows_x = torch.stack([xe, ye, ones, zeros, zeros, zeros, -xs * xe, -xs * ye], dim=1)
    rows_y = torch.stack([zeros, zeros, zeros, xe, ye, ones, -ys * xe, -ys * ye], dim=1)
    return torch.linalg.solve(torch.cat([rows_x, rows_y]), torch.cat([xs, ys]))


def perspective_warp(img: torch.Tensor, startpoints: torch.Tensor, endpoints: torch.Tensor,
                     mode: str = "bilinear") -> torch.Tensor:
    """Perspective transform of (H, W, C): the four ``startpoints`` corners
    go to ``endpoints`` (torchvision's convention), fill 0."""
    coeffs = _perspective_coeffs(startpoints.float(), endpoints.float())
    return _warp(img, coeffs, mode)


def random_rotation_params(gen: torch.Generator, degrees: float, device="cpu") -> torch.Tensor:
    """angle ~ U(-degrees, degrees), as torchvision's RandomRotation."""
    return (torch.rand((), generator=gen, device=device) * 2.0 - 1.0) * degrees


def random_perspective_params(gen: torch.Generator, height: int, width: int, distortion_scale: float,
                              device="cpu") -> tuple[torch.Tensor, torch.Tensor]:
    """Start and end points as torchvision's RandomPerspective.get_params:
    each corner moves inward by an integer offset drawn from
    [0, distortion * half + 1) along each axis."""
    dx = int(distortion_scale * (width // 2)) + 1
    dy = int(distortion_scale * (height // 2)) + 1
    hi = torch.tensor([dx, dy] * 4, device=device)
    u = (torch.rand(8, generator=gen, device=device) * hi).long().float()
    startpoints = torch.tensor([[0, 0], [width - 1, 0], [width - 1, height - 1], [0, height - 1]],
                               dtype=torch.float32, device=device)
    sign = torch.tensor([[1, 1], [-1, 1], [-1, -1], [1, -1]], dtype=torch.float32, device=device)
    endpoints = startpoints + sign * u.reshape(4, 2)
    return startpoints, endpoints
