"""ResNet50 feature extractor (2048-d), inference only.

Counterpart of ``iris_style_transfer_tpu/models/resnet.py`` (reference
torchvision resnet50 with ``fc = Identity``): conv7x7/2 + batchnorm + ReLU,
a 3x3/2 max-pool after a -inf pad of 1, bottleneck stages [3, 4, 6, 3]
(the stride on the 3x3 conv of each stage's first block), global average
pool.  ImageNet normalization runs inside the forward in float32; the
trunk runs in ``compute_dtype`` with channels_last memory; the features
come out in float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.image import imagenet_normalize
from ..runtime.profiler import span
from . import layers as L

STAGES = [(64, 3, 1), (128, 4, 2), (256, 6, 2), (512, 3, 2)]
EXPANSION = 4


def _init_bottleneck(gen, cin, width, stride, device, dtype):
    p = {
        "conv1": L.init_conv_he(gen, 1, 1, cin, width, device, dtype),
        "bn1": L.init_batchnorm(width, device, dtype),
        "conv2": L.init_conv_he(gen, 3, 3, width, width, device, dtype),
        "bn2": L.init_batchnorm(width, device, dtype),
        "conv3": L.init_conv_he(gen, 1, 1, width, width * EXPANSION, device, dtype),
        "bn3": L.init_batchnorm(width * EXPANSION, device, dtype),
    }
    if stride != 1 or cin != width * EXPANSION:
        p["downsample"] = {
            "conv": L.init_conv_he(gen, 1, 1, cin, width * EXPANSION, device, dtype),
            "bn": L.init_batchnorm(width * EXPANSION, device, dtype),
        }
    return p


def _bottleneck(p, x, stride):
    h = torch.relu(L.batchnorm(L.conv2d(x, p["conv1"]), p["bn1"]))
    h = torch.relu(L.batchnorm(L.conv2d(h, p["conv2"], stride=stride, padding=1), p["bn2"]))
    h = L.batchnorm(L.conv2d(h, p["conv3"]), p["bn3"])
    if "downsample" in p:
        x = L.batchnorm(L.conv2d(x, p["downsample"]["conv"], stride=stride), p["downsample"]["bn"])
    return torch.relu(h + x)


class ResNet50:
    """Functional ResNet50 trunk: ``feats = ResNet50.apply(params, images)``."""

    @staticmethod
    def init(gen: torch.Generator, device="cpu", dtype=torch.float32) -> dict:
        """Seeded fallback in torchvision's own init distribution
        (kaiming-normal fan_out, bias-free convs as zero biases)."""
        params = {
            "conv1": L.init_conv_he(gen, 7, 7, 3, 64, device, dtype),
            "bn1": L.init_batchnorm(64, device, dtype),
        }
        cin = 64
        for si, (width, blocks, stride) in enumerate(STAGES, start=1):
            stage = []
            for b in range(blocks):
                stage.append(_init_bottleneck(gen, cin, width, stride if b == 0 else 1, device, dtype))
                cin = width * EXPANSION
            params[f"layer{si}"] = stage
        return params

    @staticmethod
    def apply(params: dict, x: torch.Tensor, compute_dtype=torch.float32) -> torch.Tensor:
        """Channel-last RGB images (B, H, W, 3) in [0,1] -> (B, 2048) float32.
        Under a profiler a span ``resnet50.apply``."""
        with span("resnet50.apply"):
            if x.dim() == 3:
                x = x[None]
            h = imagenet_normalize(x.float().permute(0, 3, 1, 2))
            h = h.to(compute_dtype).contiguous(memory_format=torch.channels_last)
            h = torch.relu(L.batchnorm(L.conv2d(h, params["conv1"], stride=2, padding=3), params["bn1"]))
            h = F.pad(h, (1, 1, 1, 1), value=float("-inf"))
            h = L.max_pool(h, 3, 2)
            for si, (_, _, stride) in enumerate(STAGES, start=1):
                for b, bp in enumerate(params[f"layer{si}"]):
                    h = _bottleneck(bp, h, stride if b == 0 else 1)
            return h.mean(dim=(2, 3)).float()
