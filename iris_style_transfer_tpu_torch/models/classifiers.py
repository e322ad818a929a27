"""Iris classifier heads.

Counterpart of ``iris_style_transfer_tpu/models/classifiers.py`` (reference
``models/classifiers/classifiers.py``):
  * Classifier1: AdaptiveAvgPool(7,7) -> NCHW flatten -> MLP 25088 -> 4096
    -> 4096 -> num_class over the final VGG features.
  * Classifier2: per-layer channel-wise (mean || std) of the style taps,
    1920-d -> MLP 4096 -> 4096 -> num_class; std is Bessel-corrected.
Both put Dropout(0.5) after the first two ReLUs; ``train=True`` with a
``torch.Generator`` turns it on (``models/layers.py:dropout``).
"""

from __future__ import annotations

import torch

from ..ops.losses import style_stats
from . import layers as L

STYLE_FEATURE_DIM = (64 + 128 + 256 + 512) * 2


def _mlp(params: dict, x: torch.Tensor, train: bool = False, gen: torch.Generator | None = None) -> torch.Tensor:
    x = L.dropout(torch.relu(L.linear(x, params["fc0"])), 0.5, gen, train)
    x = L.dropout(torch.relu(L.linear(x, params["fc1"])), 0.5, gen, train)
    return L.linear(x, params["fc2"])


def _init_mlp(gen, din, num_class, device):
    return {
        "fc0": L.init_linear(gen, din, 4096, device),
        "fc1": L.init_linear(gen, 4096, 4096, device),
        "fc2": L.init_linear(gen, 4096, num_class, device),
    }


class Classifier1:
    @staticmethod
    def init(gen: torch.Generator, num_class: int = 152, device="cpu") -> dict:
        return _init_mlp(gen, 512 * 7 * 7, num_class, device)

    @staticmethod
    def apply(params: dict, feats: torch.Tensor, train: bool = False,
              gen: torch.Generator | None = None) -> torch.Tensor:
        """feats: (B, 512, H, W) final VGG features -> (B, num_class) logits."""
        x = L.adaptive_avg_pool(feats, (7, 7))
        return _mlp(params, x.reshape(x.shape[0], -1), train, gen)  # NCHW flatten order


class Classifier2:
    @staticmethod
    def init(gen: torch.Generator, in_features: int = STYLE_FEATURE_DIM, num_class: int = 152,
             device="cpu") -> dict:
        return _init_mlp(gen, in_features, num_class, device)

    @staticmethod
    def features(style_feats: list[torch.Tensor]) -> torch.Tensor:
        """Per-layer (mean || std) concat -> (B, 1920)."""
        parts = []
        for f in style_feats:
            mean, std = style_stats(f)
            parts.append(torch.cat([mean, std], dim=1))
        return torch.cat(parts, dim=1)

    @staticmethod
    def apply(params: dict, style_feats: list[torch.Tensor], train: bool = False,
              gen: torch.Generator | None = None) -> torch.Tensor:
        return _mlp(params, Classifier2.features(style_feats), train, gen)
