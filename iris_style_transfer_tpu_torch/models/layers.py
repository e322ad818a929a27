"""Functional NN primitives on NCHW tensors (OIHW conv, (out, in) linear).

Counterpart of ``iris_style_transfer_tpu/models/layers.py``, only what
VGG19, RITnet, the B7 U-Net, ResNet50 and the classifier and gaze heads
use.  Conv activations stay NCHW with channels_last memory so cuDNN and
the hand-written kernels all see NHWC bytes.  Initializers draw from an explicit CPU ``torch.Generator`` and
move the result to ``device``, so a seed gives the same weights on every
device.

The JAX package's TPU-layout pool variants (``POOL_STRIDED``,
``POOL_PAIRED``, the ``*_PALLAS`` flags, ``FUSE_RELU_POOL``,
``USE_MXU_FWD``, ``batch_groups``) ship off there and are not ported.  Nor
is the ``STATS_TAPS`` module flag: the fused relu+stats tap
(:func:`relu_stats`) is chosen per call, and off is the JAX default.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..ops.relu_pool import relu_max_pool  # noqa: F401  (the VGG block-1 pool)
from ..ops.relu_stats import relu_stats  # noqa: F401  (the VGG style taps under stats_taps)


# ---------------------------------------------------------------------------
# initializers (torch nn.Conv2d / nn.Linear defaults, torchvision's He init)
# ---------------------------------------------------------------------------


def _uniform(shape, bound, gen, device, dtype):
    t = torch.rand(shape, generator=gen, dtype=torch.float32) * (2 * bound) - bound
    return t.to(device=device, dtype=dtype)


def init_conv(gen: torch.Generator, kh, kw, cin, cout, device="cpu", dtype=torch.float32) -> dict:
    """kaiming_uniform(a=sqrt(5)) weights and bias, OIHW."""
    bound = math.sqrt(1.0 / (kh * kw * cin))
    return {
        "w": _uniform((cout, cin, kh, kw), bound, gen, device, dtype),
        "b": _uniform((cout,), bound, gen, device, dtype),
    }


def init_conv_he(gen: torch.Generator, kh, kw, cin, cout, device="cpu", dtype=torch.float32) -> dict:
    """Kaiming-normal (fan_out, relu gain) weights and zero bias, OIHW —
    torchvision's ``_initialize_weights`` for VGG."""
    std = math.sqrt(2.0 / (kh * kw * cout))
    w = torch.randn((cout, cin, kh, kw), generator=gen, dtype=torch.float32) * std
    return {"w": w.to(device=device, dtype=dtype), "b": torch.zeros(cout, device=device, dtype=dtype)}


def init_linear(gen: torch.Generator, din, dout, device="cpu", dtype=torch.float32) -> dict:
    bound = math.sqrt(1.0 / din)
    return {
        "w": _uniform((dout, din), bound, gen, device, dtype),
        "b": _uniform((dout,), bound, gen, device, dtype),
    }


def init_batchnorm(c, device="cpu", dtype=torch.float32) -> dict:
    kw = {"device": device, "dtype": dtype}
    return {"scale": torch.ones(c, **kw), "bias": torch.zeros(c, **kw),
            "mean": torch.zeros(c, **kw), "var": torch.ones(c, **kw)}


# ---------------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------------


def conv2d(x: torch.Tensor, p: dict, stride: int = 1, padding: int = 0) -> torch.Tensor:
    """2-D conv, NCHW x OIHW -> NCHW, weights cast to the input's dtype."""
    w, b = p["w"], p["b"]
    if w.dtype != x.dtype:
        w, b = w.to(x.dtype), b.to(x.dtype)
    return F.conv2d(x, w, b, stride=stride, padding=padding)


def linear(x: torch.Tensor, p: dict) -> torch.Tensor:
    w, b = p["w"], p["b"]
    if w.dtype != x.dtype:
        w, b = w.to(x.dtype), b.to(x.dtype)
    return F.linear(x, w, b)


def batchnorm(x: torch.Tensor, p: dict, eps: float = 1e-5) -> torch.Tensor:
    """Inference-mode batchnorm over the channel axis (dim 1), in float32."""
    shape = (1, -1, 1, 1)
    inv = torch.rsqrt(p["var"].float() + eps).reshape(shape)
    out = (x.float() - p["mean"].float().reshape(shape)) * inv * p["scale"].float().reshape(
        shape
    ) + p["bias"].float().reshape(shape)
    return out.to(x.dtype)


class _MaxPool2TieAll(torch.autograd.Function):
    """Non-overlapping 2x2 max-pool whose backward gives the full cotangent
    to every element that reaches its window maximum (JAX
    ``_max_pool_nonoverlap``); ``F.max_pool2d`` would pick one winner."""

    @staticmethod
    def forward(ctx, x):
        b, c, h, w = x.shape
        y = x.unflatten(3, (w // 2, 2)).unflatten(2, (h // 2, 2)).amax(dim=(3, 5))
        ctx.save_for_backward(x, y)
        return y

    @staticmethod
    def backward(ctx, ct):
        x, y = ctx.saved_tensors
        b, c, h, w = x.shape
        x6 = x.unflatten(3, (w // 2, 2)).unflatten(2, (h // 2, 2))
        g6 = torch.where(x6 == y[:, :, :, None, :, None], ct[:, :, :, None, :, None], 0.0)
        return g6.reshape(b, c, h, w)


def max_pool(x: torch.Tensor, window: int = 2, stride: int | None = None) -> torch.Tensor:
    """VALID max-pool, ``stride`` defaulting to ``window``.  Even extents at
    window == stride == 2 take the tie-to-all autograd Function; other
    cases, ResNet's overlapping 3x3/2 pool among them, take
    ``F.max_pool2d`` (floor mode; its one-winner backward matches XLA's
    reduce_window gradient)."""
    stride = stride or window
    if window == stride == 2 and x.shape[2] % 2 == 0 and x.shape[3] % 2 == 0:
        return _MaxPool2TieAll.apply(x)
    return F.max_pool2d(x, window, stride)


def avg_pool(x: torch.Tensor, window: int = 2) -> torch.Tensor:
    return F.avg_pool2d(x.float(), window, window).to(x.dtype)


def adaptive_avg_pool(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """AdaptiveAvgPool2d (torch's bin edges, which the JAX package copies)."""
    return F.adaptive_avg_pool2d(x.float(), out_hw).to(x.dtype)


def upsample_nearest(x: torch.Tensor, scale: int = 2) -> torch.Tensor:
    """Nearest-neighbour integer upsample; keeps channels_last memory."""
    return F.interpolate(x, scale_factor=scale, mode="nearest")


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.01) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope)


def dropout(x: torch.Tensor, rate: float, gen: torch.Generator | None, train: bool) -> torch.Tensor:
    """Inverted dropout: each element kept with probability ``1 - rate``
    (a Bernoulli mask drawn from ``gen`` on ``x``'s device) and scaled by
    ``1 / (1 - rate)``; the identity unless ``train`` and ``gen`` is given."""
    if not train or rate == 0.0 or gen is None:
        return x
    keep = 1.0 - rate
    mask = torch.empty(x.shape, device=x.device).bernoulli_(keep, generator=gen).to(torch.bool)
    return torch.where(mask, x / keep, 0.0).to(x.dtype)


def block_dropout(x: torch.Tensor, rate: float, gen: torch.Generator | None, train: bool,
                  block: tuple | None) -> torch.Tensor:
    """:func:`dropout` of ``x``, the block ``whole[index]`` of a tensor of
    ``shape`` split over ranks (``block = (shape, index)``; None: ``x`` is
    the whole tensor).  The mask is drawn for the whole tensor and indexed,
    so that the split tensor drops what the whole one would."""
    if block is None:
        return dropout(x, rate, gen, train)
    if not train or rate == 0.0 or gen is None:
        return x
    keep = 1.0 - rate
    shape, index = block
    mask = torch.empty(shape, device=x.device).bernoulli_(keep, generator=gen).to(torch.bool)[index]
    return torch.where(mask, x / keep, 0.0).to(x.dtype)
