"""Both classifier heads' MLPs (25088 and 1920 inputs, 4096, 4096, classes)."""

from __future__ import annotations


def flops(b: int, classes: int) -> int:
    mac = sum(din * 4096 + 4096 * 4096 + 4096 * classes for din in (25088, 1920))
    return 2 * b * mac
