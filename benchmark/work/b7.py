"""The B7 U-Net's forward (one logits pass; an apply with its flip is two)
at the padded 416x640 frame, and the work of each stride-1 depthwise
conv + batchnorm + SiLU (the port's hand-written kernel), bf16 in and out,
f32 taps and affine."""

from __future__ import annotations

import functools

import torch

from benchmark import device
from benchmark.reference import b7 as ref
from benchmark.work._count import flops as count_flops, meta_params

ITEM = 2


@functools.lru_cache(maxsize=None)
def logits_flops_per_frame(h: int = 416, w: int = 640) -> int:
    x = torch.empty(1, 3, h, w, device="meta")
    return count_flops(lambda: ref.logits(meta_params(ref.shapes()), x))


def depthwise_calls(h: int = 416, w: int = 640) -> list[tuple[int, int, int, int]]:
    """(k, C, H, W) of each stride-1 depthwise conv of one logits pass."""
    h, w = -(-h // 2), -(-w // 2)
    out = []
    for e, k, s, ci, _ in ref.blocks():
        if s == 1:
            out.append((k, ci * e, h, w))
        else:
            h, w = -(-h // 2), -(-w // 2)
    return out


def depthwise_bound_s(b: int, h: int = 416, w: int = 640) -> float:
    """The bound of one logits pass's depthwise work on ``b`` frames: x read
    and y written once in bf16, the taps and affine in f32; 2 k^2 FLOPs an
    output."""
    total = 0.0
    for k, c, hh, ww in depthwise_calls(h, w):
        n = b * c * hh * ww
        total += device.bound_s(2 * n * ITEM + c * (k * k + 2) * 4, 2 * k * k * n, "bf16")
    return total
