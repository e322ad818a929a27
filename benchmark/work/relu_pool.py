"""The fused ReLU + 2x2 max-pool (VGG's relu1_2 + pool1), forward and
backward, bf16, at (B, C, H, W)."""

from __future__ import annotations

from benchmark.device import bound_s

ITEM = 2  # bfloat16


def fwd_bound_s(b: int, c: int, h: int, w: int) -> float:
    x = b * c * h * w * ITEM
    return bound_s(x + x // 4)  # read x, write y


def bwd_bound_s(b: int, c: int, h: int, w: int) -> float:
    x = b * c * h * w * ITEM
    return bound_s(x + x // 4 + x // 4 + x)  # read x, y and the cotangent, write the gradient
