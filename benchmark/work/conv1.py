"""VGG's conv1_1 (3x3, pad 1) forward, bf16 in and out, at (B, C_in, H, W)."""

from __future__ import annotations


ITEM = 2


def bound_s(b: int, cin: int, cout: int, h: int, w: int) -> float:
    from benchmark import device

    nbytes = (b * cin * h * w + b * cout * h * w + cout * cin * 9 + cout) * ITEM
    return device.bound_s(nbytes, 2 * b * h * w * cout * cin * 9, "bf16")
