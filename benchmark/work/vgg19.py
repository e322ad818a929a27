"""VGG19 at 224x224 crops: the full forward (the classifiers' features),
the NST's forward to relu4_2, and one NST closure (that forward and the
gradient with respect to the image)."""

from __future__ import annotations

import functools

import torch

from benchmark.reference import vgg as ref
from benchmark.work._count import flops, meta_params


def _params():
    return meta_params({n: {"w": (co, ci, 3, 3), "b": (co,)} for n, (ci, co) in ref.widths().items()})


@functools.lru_cache(maxsize=None)
def forward_flops(b: int, size: int = 224) -> int:
    x = torch.empty(b, 3, size, size, device="meta")
    return flops(lambda: ref.vgg_features(_params(), x))


@functools.lru_cache(maxsize=None)
def nst_forward_flops(b: int, size: int = 224) -> int:
    x = torch.empty(b, 3, size, size, device="meta")
    return flops(lambda: ref.vgg_features(_params(), x, taps=ref.CONTENT + ref.STYLE, stop=ref.CONTENT[-1]))


@functools.lru_cache(maxsize=None)
def nst_closure_flops(b: int, size: int = 224) -> int:
    p = _params()

    def closure():
        x = torch.empty(b, 3, size, size, device="meta", requires_grad=True)
        _, taps = ref.vgg_features(p, x, taps=ref.CONTENT + ref.STYLE, stop=ref.CONTENT[-1])
        loss = sum(t.sum() for t in taps.values())
        torch.autograd.grad(loss, x)

    return flops(closure)
