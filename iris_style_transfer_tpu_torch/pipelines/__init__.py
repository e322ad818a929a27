"""Masked-iris extraction and recomposition."""

from .iris import composite_batch, extract_iris_batch, iris_mask_from_seg, make_ist_fn, mask_and_crop_iris
