"""ResNet50's trunk at the frames' size (gray frames as RGB)."""

from __future__ import annotations

import functools

import torch

from benchmark.reference import resnet as ref
from benchmark.work._count import flops as count_flops, meta_params


@functools.lru_cache(maxsize=None)
def flops_per_frame(h: int = 400, w: int = 640) -> int:
    x = torch.empty(1, h, w, 3, device="meta")
    return count_flops(lambda: ref.features(meta_params(ref.shapes()), x))
