"""FlopCounterMode over a function of meta tensors."""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode


def meta_params(tree):
    """The same tree of empty meta tensors (shapes of ``tree``'s leaves,
    which may themselves be shapes)."""
    if isinstance(tree, dict):
        return {k: meta_params(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [meta_params(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return torch.empty(tree.shape, device="meta")
    return torch.empty(tree, device="meta")


def flops(fn, *args) -> int:
    with FlopCounterMode(display=False) as fc:
        fn(*args)
    return int(fc.get_total_flops())
