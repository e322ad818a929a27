"""Masked-iris extraction and recomposition, batched.

Counterpart of ``iris_style_transfer_tpu/pipelines/iris.py`` (reference
``pipelines.mask_and_crop_iris`` and the IST recomposition): iris mask =
(seg == 2) & (frame <= glint threshold), crop to the nonzero bbox of the
masked frame, resize, grayscale -> RGB; and the inverse paste back into
the frame.  Frames and masks are channel-last (B, H, W, 1).
``area_opening`` stays off, as it is by default in the JAX package.
"""

from __future__ import annotations

import torch

from ..ops.image import composite_iris, crop_and_resize, gray_to_rgb, nonzero_bbox, rgb_to_grayscale

IRIS_CLASS = 2


def iris_mask_from_seg(seg: torch.Tensor, img: torch.Tensor, glint_threshold: float = 0.8) -> torch.Tensor:
    """(B, H, W) labels + (B, H, W, 1) frames -> (B, H, W, 1) bool iris mask."""
    return (seg == IRIS_CLASS)[..., None] & (img <= glint_threshold)


def extract_iris_batch(
    imgs: torch.Tensor,
    segs: torch.Tensor,
    glint_threshold: float = 0.8,
    out_size: tuple[int, int] = (224, 224),
    rgb: bool = True,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Frames (B, H, W, 1) + labels (B, H, W) -> (irises (B, *out_size, 3 or
    1), masks (B, H, W, 1), bboxes (B, 4)); the bbox is the nonzero extent
    of the masked frame."""
    masks = iris_mask_from_seg(segs, imgs, glint_threshold)
    masked = imgs * masks.to(imgs.dtype)
    bboxes = nonzero_bbox(masked[..., 0])
    irises = crop_and_resize(masked, bboxes, out_size)
    if rgb:
        irises = gray_to_rgb(irises)
    return irises, masks, bboxes


def composite_batch(
    frames: torch.Tensor, stylized_rgb: torch.Tensor, masks: torch.Tensor, bboxes: torch.Tensor
) -> torch.Tensor:
    """RGB -> grayscale, resize each stylized iris (B, h, w, 3) back into its
    bbox, re-mask and composite into the frames (B, H, W, 1)."""
    return composite_iris(frames, rgb_to_grayscale(stylized_rgb), masks, bboxes)
