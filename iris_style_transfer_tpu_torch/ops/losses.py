"""NST loss functions with the reference's numerical conventions.

Counterpart of ``iris_style_transfer_tpu/ops/losses.py``:
  * content_loss_l2 — ``0.5 * sum_i w_i * mean((p_i - t_i)^2)``
  * style_loss_gram — ``0.25 * sum_i w_i * sum((G(p_i) - G_t_i)^2)``
  * style_loss_bn   — ``sum_i w_i * sum((mu_p-mu_t)^2 + (sd_p-sd_t)^2)/C_i``
    with per-channel spatial mean and Bessel-corrected std;
    ``style_loss_bn_stats`` is the same on precomputed (mean, std) pairs;
    ``style_stats_split`` computes the pairs of an image split on H over
    ranks from the slabs' sums.

Features are NCHW; every reduction accumulates in float32.  The BN loss's
per-channel sums go through ``ops/style_sums.py``.  The losses
return device scalars and never read them back.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..parallel.mesh import sum_over_group
from .gram import gram_matrix
from .style_sums import style_sums


def _weights(weights: Sequence[float] | None, n: int) -> Sequence[float]:
    return [1.0] * n if weights is None else list(weights)


def content_loss_l2(
    preds: Sequence[torch.Tensor],
    targets: Sequence[torch.Tensor],
    weights: Sequence[float] | None = None,
) -> torch.Tensor:
    """0.5 * sum_i w_i * mean((p_i - t_i)^2)."""
    loss = 0.0
    for p, t, w in zip(preds, targets, _weights(weights, len(targets))):
        d = p.float() - t.float()
        loss = loss + torch.mean(d * d) * w
    return loss * 0.5


def style_loss_gram(
    preds: Sequence[torch.Tensor],
    target_grams: Sequence[torch.Tensor],
    weights: Sequence[float] | None = None,
    gram_fn=gram_matrix,
) -> torch.Tensor:
    """0.25 * sum_i w_i * sum((G(p_i) - G_t_i)^2)."""
    loss = 0.0
    for p, gt, w in zip(preds, target_grams, _weights(weights, len(target_grams))):
        d = gram_fn(p).float() - gt.float()
        loss = loss + torch.sum(d * d) * w
    return loss * 0.25


def stats_from_sums(s1: torch.Tensor, s2: torch.Tensor, n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(mean, Bessel std) from float32 (sum, sum-of-squares) over n elements."""
    mean = s1 / n
    var = torch.clamp_min(s2 - n * mean * mean, 0.0) / (n - 1)
    return mean, torch.sqrt(var)


def style_stats(feat: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-channel spatial (mean, std) of (B, C, H, W) features -> (B, C),
    from one sum / sum-of-squares pass in float32 (:func:`style_sums`: the
    hand-written kernels on a CUDA tensor)."""
    return stats_from_sums(*style_sums(feat), feat.shape[-2] * feat.shape[-1])


def stats_from_slab_sums(sums: Sequence[tuple[torch.Tensor, torch.Tensor]], ns: Sequence[int],
                         group) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """Each tap's (mean, std) from the (sum, sum of squares) of this rank's
    slab of it: the sums of every tap added over ``group`` (the model
    group, over whose ranks the image's H is split) in one packed
    reduction, whose backward hands each slab the cotangent of the whole
    image's sums; ``ns`` are the whole taps' H*W."""
    flat = [s.reshape(-1) for pair in sums for s in pair]
    total = sum_over_group(torch.cat(flat), group).split([t.numel() for t in flat])
    return [stats_from_sums(total[2 * i].view_as(s1), total[2 * i + 1].view_as(s2), n)
            for i, ((s1, s2), n) in enumerate(zip(sums, ns))]


def style_stats_split(feats: Sequence[torch.Tensor], group, parts: int) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """:func:`style_stats` of features whose H is split over ``group``'s
    ``parts`` ranks, each rank holding its slab (``parallel/mesh.py``)."""
    return stats_from_slab_sums([style_sums(f) for f in feats], [f.shape[-2] * f.shape[-1] * parts for f in feats], group)


def style_loss_bn_stats(
    pred_stats: Sequence[tuple[torch.Tensor, torch.Tensor]],
    target_stats: Sequence[tuple[torch.Tensor, torch.Tensor]],
    weights: Sequence[float] | None = None,
) -> torch.Tensor:
    """:func:`style_loss_bn` on (mean, std) pairs the VGG forward already
    computed with the fused relu+stats tap (``stats_taps``)."""
    loss = 0.0
    for (p_mean, p_std), (t_mean, t_std), w in zip(pred_stats, target_stats,
                                                   _weights(weights, len(target_stats))):
        c = p_mean.shape[-1]
        term = torch.sum((p_mean - t_mean) ** 2 + (p_std - t_std) ** 2)
        loss = loss + term * (w / c)
    return loss


def style_loss_bn(
    preds: Sequence[torch.Tensor],
    target_stats: Sequence[tuple[torch.Tensor, torch.Tensor]],
    weights: Sequence[float] | None = None,
) -> torch.Tensor:
    """sum_i w_i * sum_{b,c}((mu_p-mu_t)^2 + (sd_p-sd_t)^2) / C_i."""
    return style_loss_bn_stats([style_stats(p) for p in preds], target_stats, weights)
