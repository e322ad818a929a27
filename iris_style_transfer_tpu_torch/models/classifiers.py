"""Iris classifier heads.

Counterpart of ``iris_style_transfer_tpu/models/classifiers.py`` (reference
``models/classifiers/classifiers.py``):
  * Classifier1: AdaptiveAvgPool(7,7) -> NCHW flatten -> MLP 25088 -> 4096
    -> 4096 -> num_class over the final VGG features.
  * Classifier2: per-layer channel-wise (mean || std) of the style taps,
    1920-d -> MLP 4096 -> 4096 -> num_class; std is Bessel-corrected.
Both put Dropout(0.5) after the first two ReLUs; ``train=True`` with a
``torch.Generator`` turns it on (``models/layers.py:dropout``).

With a ``mesh`` (``parallel/mesh.py``) the features are this rank's block
of the batch, and each dropout mask is drawn for the whole batch and cut
to the block, so the ranks drop what one device would.  On a mesh with a
``model`` axis the parameters are split by ``mlp_tp_spec`` (Megatron):
fc0's outputs and fc1's inputs over the model group, one ``all_reduce`` of
fc1's partial sums forward and one of fc0's input gradient backward.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.losses import style_stats
from ..parallel.mesh import Mesh, activation_block, all_reduce, sum_over_group
from . import layers as L

STYLE_FEATURE_DIM = (64 + 128 + 256 + 512) * 2


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the gradient summed over the model group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.clone(), ctx.group), None


def _mlp(params: dict, x: torch.Tensor, train: bool = False, gen: torch.Generator | None = None,
         mesh: Mesh | None = None) -> torch.Tensor:
    tp = mesh is not None and mesh.shape["model"] > 1
    if tp:
        x = _CopyToModel.apply(x, mesh.model_group)
    x = torch.relu(L.linear(x, params["fc0"]))
    x = L.block_dropout(x, 0.5, gen, train, activation_block(mesh, x, tp))
    if tp:
        w, b = params["fc1"]["w"], params["fc1"]["b"]
        x = sum_over_group(F.linear(x, w.to(x.dtype)), mesh.model_group) + b.to(x.dtype)
    else:
        x = L.linear(x, params["fc1"])
    x = torch.relu(x)
    x = L.block_dropout(x, 0.5, gen, train, activation_block(mesh, x))
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
              gen: torch.Generator | None = None, mesh: Mesh | None = None) -> torch.Tensor:
        """feats: (B, 512, H, W) final VGG features -> (B, num_class) logits."""
        x = L.adaptive_avg_pool(feats, (7, 7))
        return _mlp(params, x.reshape(x.shape[0], -1), train, gen, mesh)  # NCHW flatten order


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
              gen: torch.Generator | None = None, mesh: Mesh | None = None) -> torch.Tensor:
        return _mlp(params, Classifier2.features(style_feats), train, gen, mesh)
