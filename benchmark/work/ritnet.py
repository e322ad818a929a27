"""RITnet's forward at the frames' size (the network; the preprocessing
does no multiply-add work)."""

from __future__ import annotations

import functools

import torch

from benchmark.reference import ritnet as ref
from benchmark.work._count import flops as count_flops, meta_params

C = 32


def _shapes() -> dict:
    conv = lambda co, ci, k: {"w": (co, ci, k, k), "b": (co,)}  # noqa: E731
    bn = {k: (C,) for k in ("scale", "bias", "mean", "var")}
    p = {}
    for i in range(1, 6):
        ci = 1 if i == 1 else C
        p[f"down{i}"] = {"conv1": conv(C, ci, 3), "conv21": conv(C, ci + C, 1), "conv22": conv(C, C, 3),
                         "conv31": conv(C, ci + 2 * C, 1), "conv32": conv(C, C, 3), "bn": bn}
    for i in range(1, 5):
        p[f"up{i}"] = {"conv11": conv(C, 2 * C, 1), "conv12": conv(C, C, 3), "conv21": conv(C, 3 * C, 1),
                       "conv22": conv(C, C, 3)}
    p["out_conv"] = conv(4, C, 1)
    return p


@functools.lru_cache(maxsize=None)
def flops_per_frame(h: int, w: int) -> int:
    x = torch.empty(1, 1, h, w, device="meta")
    return count_flops(lambda: ref.ritnet_logits(meta_params(_shapes()), x))


def flops(b: int, h: int, w: int) -> int:
    return b * flops_per_frame(h, w)
