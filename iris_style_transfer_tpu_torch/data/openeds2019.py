"""OpenEDS2019 IST dataset construction on the device.

Counterpart of ``iris_style_transfer_tpu/data/openeds2019.py``
(``build_ist_dataset``, ``ISTDataset``, ``sample_other``; reference
``data_preprocessing.py:110-251``): per content frame, RITnet
segmentation, pre-NST IoUs against the ground truth, the iris mask and
bbox, and a style donor drawn from another user.  Donor sampling uses the
host ``random`` module in the same call order as the JAX package, so a
seed picks the same donors in both.

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
    quantize_u8,
    quantize_u16,
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
