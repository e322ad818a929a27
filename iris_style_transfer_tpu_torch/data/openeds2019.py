"""OpenEDS2019 dataset construction on the device.

Counterpart of ``iris_style_transfer_tpu/data/openeds2019.py``:
  * ``build_ist_dataset``, ``ISTDataset``, ``sample_other`` (reference
    ``data_preprocessing.py:110-251``): per content frame, RITnet
    segmentation, pre-NST IoUs against the ground truth, the iris mask and
    bbox, and a style donor drawn from another user.  Donor sampling uses
    the host ``random`` module in the same call order as the JAX package,
    so a seed picks the same donors in both.
  * ``build_ir_dataset`` (reference ``data_preprocessing.py:15-108``), the
    classifier training set: per frame the iris mask times the glint mask,
    the 224x224 crop of its bbox, the optional random rotation and
    perspective (``_augment_one``), and u16 quantization.  The random
    draws come from a ``torch.Generator``, so their stream is not
    ``jax.random``'s.

Loading the real OpenEDS data from disk is not ported yet (ROADMAP); the
workload runs on the synthetic twin.
"""

from __future__ import annotations

import random
from dataclasses import dataclass

import numpy as np
import torch

from ..models.ritnet import RITnet
from ..ops.image import (
    as_label_map,
    crop_and_resize,
    nonzero_bbox,
    pack_labels2,
    pack_mask_bits,
    perspective_warp,
    quantize_u8,
    quantize_u16,
    random_perspective_params,
    random_rotation_params,
    rotate,
    to_unit_float,
)
from ..ops.metrics import iou_per_class
from ..pipelines.iris import iris_mask_from_seg


def sample_other(label: int, labels: list[int]) -> int:
    """Rejection-sample an index of another class (reference ``:237-251``)."""
    idx = random.randrange(len(labels))
    while labels[idx] == label:
        idx = random.randrange(len(labels))
    return idx


@dataclass
class ISTDataset:
    """Arrays over a whole split; image-shaped fields live on the device."""

    c_imgs: torch.Tensor  # (N, H, W, 1) uint8 frames
    c_labels: np.ndarray  # (N,) int32
    c_masks_iris: torch.Tensor  # (N, H, W//8, 1) uint8 bit-packed iris masks
    c_iris_bbs: torch.Tensor  # (N, 4) int32
    c_masks_gt: torch.Tensor  # (N, H, W//4) uint8 2-bit packed GT labels
    s_irises: torch.Tensor  # (N, 224, 224, 1) float32 donor crops (u16 levels)
    s_labels: np.ndarray  # (N,) int32
    ious_dev: torch.Tensor  # (4, N) pre-NST per-class IoUs

    def __len__(self):
        return len(self.c_labels)

    @property
    def ious(self) -> np.ndarray:
        return self.ious_dev.cpu().numpy()

    @property
    def mious(self) -> np.ndarray:
        return np.mean(self.ious, axis=0, dtype=np.float32)


def _process(ritnet_params, frames_u8, gts_packed, glint_threshold, out_size):
    frames = to_unit_float(frames_u8)
    seg = RITnet.apply(ritnet_params, frames)
    ious, _ = iou_per_class(seg, as_label_map(gts_packed, seg.shape[-1]))
    masks = iris_mask_from_seg(seg, frames, glint_threshold)
    masked = frames * masks.to(frames.dtype)
    bboxes = nonzero_bbox(masked[..., 0])
    crops = crop_and_resize(masked, bboxes, out_size)
    # the JAX package keeps crops as uint16; the same levels as float32
    return ious, pack_mask_bits(masks), bboxes, to_unit_float(quantize_u16(crops))


@torch.no_grad()
def build_ist_dataset(
    c_imgs: list[np.ndarray],
    c_labels: list[int],
    c_masks_gt: list[np.ndarray],
    ritnet_params: dict,
    glint_threshold: float = 0.8,
    out_size: tuple[int, int] = (224, 224),
    chunk: int = 32,
    device="cpu",
) -> ISTDataset:
    """Segment and crop the content frames in chunks of ``chunk`` on
    ``device``, then draw one style donor per frame."""
    n = len(c_imgs)
    if not n == len(c_labels) == len(c_masks_gt):
        raise ValueError("c_imgs, c_labels and c_masks_gt must have the same length")
    frames_all = torch.from_numpy(quantize_u8(np.stack(c_imgs))).to(device)
    gts_all = torch.from_numpy(pack_labels2(np.stack(c_masks_gt).astype(np.uint8))).to(device)
    parts = [
        _process(ritnet_params, frames_all[i : i + chunk], gts_all[i : i + chunk],
                 glint_threshold, out_size)
        for i in range(0, n, chunk)
    ]
    ious = torch.cat([p[0] for p in parts], dim=1)
    masks = torch.cat([p[1] for p in parts])
    bbs = torch.cat([p[2] for p in parts])
    crops = torch.cat([p[3] for p in parts])
    s_idx = np.asarray([sample_other(l, c_labels) for l in c_labels])
    return ISTDataset(
        c_imgs=frames_all,
        c_labels=np.asarray(c_labels, np.int32),
        c_masks_iris=masks,
        c_iris_bbs=bbs,
        c_masks_gt=gts_all,
        s_irises=crops[torch.as_tensor(s_idx, device=crops.device)],
        s_labels=np.asarray(c_labels, np.int32)[s_idx],
        ious_dev=ious,
    )


def _augment_one(img: torch.Tensor, gen: torch.Generator, rotation_prob: float, rotation_degree: float,
                 perspect_prob: float, perspect_degree: float) -> torch.Tensor:
    """Random rotation (nearest) with probability ``rotation_prob``, then a
    random perspective (bilinear) with probability ``perspect_prob``, of one
    (H, W, C) crop; ``gen`` is a CPU generator, so the draws and the
    branches stay on the host."""
    h, w, _ = img.shape
    if torch.rand((), generator=gen).item() < rotation_prob:
        img = rotate(img, random_rotation_params(gen, rotation_degree).to(img.device), mode="nearest")
    if torch.rand((), generator=gen).item() < perspect_prob:
        sp, ep = random_perspective_params(gen, h, w, perspect_degree)
        img = perspective_warp(img, sp.to(img.device), ep.to(img.device), mode="bilinear")
    return img


@torch.no_grad()
def build_ir_dataset(
    xs: list[np.ndarray],
    ys: list[int],
    ritnet_params: dict,
    gen: torch.Generator,
    rotation_prob: float = 0.0,
    rotation_degree: float = 180.0,
    perspect_prob: float = 0.0,
    perspect_degree: float = 0.3,
    glint_threshold: float = 0.8,
    out_size: tuple[int, int] = (224, 224),
    chunk: int = 32,
    device="cpu",
) -> tuple[np.ndarray, np.ndarray]:
    """Iris crops for classifier training, in chunks of ``chunk`` frames on
    ``device``: RITnet, the iris and glint masks, the bbox crop resized to
    ``out_size``, the optional augmentation, u16 quantization.  The chunks
    are concatenated on the device and fetched once.  Returns (N, oh, ow, 1)
    uint16 crops (dequantize with ``ops.image.to_unit_float``) and (N,)
    int32 labels."""
    if len(xs) != len(ys):
        raise ValueError("xs and ys must have the same length")
    augment = rotation_prob > 0 or perspect_prob > 0
    parts = []
    for i in range(0, len(xs), chunk):
        frames = to_unit_float(torch.from_numpy(quantize_u8(np.stack(xs[i : i + chunk]))).to(device))
        seg = RITnet.apply(ritnet_params, frames)
        masks = iris_mask_from_seg(seg, frames, glint_threshold)
        masked = frames * masks.to(frames.dtype)
        crops = crop_and_resize(masked, nonzero_bbox(masked[..., 0]), out_size)
        if augment:
            crops = torch.stack([_augment_one(c, gen, rotation_prob, rotation_degree, perspect_prob,
                                              perspect_degree) for c in crops])
        parts.append(quantize_u16(crops))
    if not parts:
        return np.zeros((0, *out_size, 1), np.uint16), np.asarray(ys, np.int32)
    return torch.cat(parts).cpu().numpy(), np.asarray(ys, np.int32)
