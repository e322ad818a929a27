"""Precision of the reference's products, and the lower ones of the control.

``F32`` is the reference: inputs and weights of every convolution, linear
layer and resampling product as they are, in float32 with TF32 off
(:func:`exact_f32`).  ``BF16`` holds the convolutions' inputs, weights and
outputs in bfloat16, as a configuration that computes in bfloat16 states;
the NST's gradient is judged against it, because the max-pool's
tie-to-all gradient depends on which window elements tie, and holding
activations in bfloat16 makes ties that float32 does not have.  The control rounds them to the nearest precision
below what the configuration states for that product: fp8 (e4m3, one
scale per tensor) where the program computes in bfloat16, bfloat16 where
it computes in float32 with cuDNN's default TF32, and TF32 where it
computes in float32 with TF32 off.  The rounding applies to the forward
values and to the gradients that flow back through them.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Callable

import torch

FP8_MAX = 448.0  # the largest finite float8_e4m3fn


def _identity(x: torch.Tensor) -> torch.Tensor:
    return x


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under one scale per tensor (amax -> 448),
    in x's floating type."""
    scale = torch.clamp_min(x.abs().amax(), 1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """x with its mantissa rounded to TF32's 10 bits (to nearest, ties away)."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


class _Round(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, fn):
        ctx.fn = fn
        return fn(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.fn(g), None


@dataclass(frozen=True)
class Precision:
    """``low`` rounds what the program computes in bfloat16; ``tf32``
    what it computes in float32 under cuDNN's default TF32 (RITnet);
    ``f32`` what it computes in float32 with TF32 off (the resampling)."""

    name: str
    low: Callable = _identity
    tf32: Callable = _identity
    f32: Callable = _identity

    def q(self, kind: str, x: torch.Tensor) -> torch.Tensor:
        fn = getattr(self, kind)
        if fn is _identity:
            return x
        return _Round.apply(x, fn) if x.requires_grad else fn(x)


F32 = Precision("f32")
# the configuration's own bf16: activations held in bf16 (the NST gradient's
# ties under the max-pool depend on it), products accumulated in float32
BF16 = Precision("bf16", low=round_bf16)
CONTROL = Precision("control", low=round_fp8, tf32=round_bf16, f32=round_tf32)


@contextlib.contextmanager
def exact_f32():
    """TF32 off for cuBLAS and cuDNN inside the block, restored after."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old
