"""Masked-iris extraction and recomposition, batched.

Counterpart of ``iris_style_transfer_tpu/pipelines/iris.py`` (reference
``pipelines.mask_and_crop_iris`` and the IST recomposition): iris mask =
(seg == 2) & (frame <= glint threshold), crop to the nonzero bbox of the
masked frame, resize, grayscale -> RGB; and the inverse paste back into
the frame.  Frames and masks are channel-last (B, H, W, 1); the NST takes
and returns NCHW images.  Area opening (``ops/connected.py``) removes the
mask's small blobs when asked for; it is off by default, as in the JAX
package.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..models.ritnet import RITnet
from ..ops.connected import area_opening
from ..ops.image import composite_iris, crop_and_resize, gray_to_rgb, nonzero_bbox, rgb_to_grayscale

IRIS_CLASS = 2


def iris_mask_from_seg(seg: torch.Tensor, img: torch.Tensor, glint_threshold: float = 0.8, open_area: int = 0,
                       connectivity: int = 2) -> torch.Tensor:
    """(B, H, W) labels + (B, H, W, 1) frames -> (B, H, W, 1) bool iris
    mask; with ``open_area > 0`` its components under ``open_area`` pixels
    are removed."""
    m = (seg == IRIS_CLASS)[..., None] & (img <= glint_threshold)
    if open_area > 0:
        m = area_opening(m[..., 0], open_area, connectivity)[..., None]
    return m


def extract_iris_batch(
    imgs: torch.Tensor,
    segs: torch.Tensor,
    glint_threshold: float = 0.8,
    out_size: tuple[int, int] = (224, 224),
    rgb: bool = True,
    open_area: int = 0,
    connectivity: int = 2,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Frames (B, H, W, 1) + labels (B, H, W) -> (irises (B, *out_size, 3 or
    1), masks (B, H, W, 1), bboxes (B, 4)); the bbox is the nonzero extent
    of the masked frame.  ``open_area``: see :func:`iris_mask_from_seg`."""
    masks = iris_mask_from_seg(segs, imgs, glint_threshold, open_area, connectivity)
    masked = imgs * masks.to(imgs.dtype)
    bboxes = nonzero_bbox(masked[..., 0])
    irises = crop_and_resize(masked, bboxes, out_size)
    if rgb:
        irises = gray_to_rgb(irises)
    return irises, masks, bboxes


def mask_and_crop_iris(
    x: torch.Tensor,
    ritnet_params: dict,
    glint_threshold: float = 0.8,
    area_threshold: int = 500,
    connectivity: int = 2,
    out_size: tuple[int, int] = (224, 224),
    use_area_opening: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The ``mask_and_crop_iris`` entry point, RITnet-backed and batched:
    (B, H, W, 1) eye frames in [0,1] -> (RGB iris crops (B, *out_size, 3),
    iris masks (B, H, W, 1), int bboxes (B, 4) ``[r_min, c_min, r_max,
    c_max]``).  ``use_area_opening`` removes the mask's components under
    ``area_threshold`` pixels before the crop."""
    seg = RITnet.apply(ritnet_params, x)
    return extract_iris_batch(x, seg, glint_threshold, out_size=out_size, rgb=True,
                              open_area=area_threshold if use_area_opening else 0, connectivity=connectivity)


def composite_batch(
    frames: torch.Tensor, stylized_rgb: torch.Tensor, masks: torch.Tensor, bboxes: torch.Tensor
) -> torch.Tensor:
    """RGB -> grayscale, resize each stylized iris (B, h, w, 3) back into its
    bbox, re-mask and composite into the frames (B, H, W, 1)."""
    return composite_iris(frames, rgb_to_grayscale(stylized_rgb), masks, bboxes)


def make_ist_fn(nst_fn: Callable) -> Callable:
    """Extraction -> NST -> recomposition as one function:
    ``fn(vgg_params, frames, segs, s_irises_rgb) -> (new_frames, irises,
    result)``, with ``s_irises_rgb`` (B, h, w, 3) as :func:`extract_iris_batch`
    returns crops, and ``result`` the batch's NSTResult (NCHW images)."""

    def fn(vgg_params, frames, segs, s_irises_rgb, glint_threshold=0.8):
        irises, masks, bboxes = extract_iris_batch(frames, segs, glint_threshold)
        result = nst_fn(vgg_params, irises.permute(0, 3, 1, 2), s_irises_rgb.permute(0, 3, 1, 2))
        new_frames = composite_batch(frames, result.x.permute(0, 2, 3, 1), masks, bboxes)
        return new_frames, irises, result

    return fn
