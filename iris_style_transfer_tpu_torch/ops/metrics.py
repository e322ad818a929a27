"""Classification and segmentation metrics.

Counterpart of ``iris_style_transfer_tpu/ops/metrics.py`` (reference
``utils.cal_metrics`` / ``utils.cal_IoUs``): cross-entropy, macro
one-vs-rest ROC AUC from tie-averaged ranks, accuracy, multiclass MCC and
macro precision/recall/F1 with zero_division=0, all from a confusion matrix
— sklearn's numbers without sklearn.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross entropy."""
    return F.cross_entropy(logits.float(), labels.long())


def roc_auc_ovr(labels: torch.Tensor, probs: torch.Tensor, present_only: bool = False) -> torch.Tensor:
    """Macro one-vs-rest ROC AUC of (N, K) probabilities.  With
    ``present_only=False`` any class without both positives and negatives
    gives -1 (the reference's fallback); ``True`` averages over the classes
    that have both."""
    n, k = probs.shape
    onehot = F.one_hot(labels.long(), k).float()  # (N, K)
    n_pos = onehot.sum(dim=0)
    n_neg = n - n_pos
    scores = probs.float().t().contiguous()  # (K, N)
    s_sorted, _ = torch.sort(scores, dim=1)
    cnt_less = torch.searchsorted(s_sorted, scores, side="left").float()
    cnt_leq = torch.searchsorted(s_sorted, scores, side="right").float()
    ranks = (cnt_less + cnt_leq + 1.0) / 2.0  # average tie ranks, 1-based
    pos_rank_sum = (ranks * onehot.t()).sum(dim=1)
    denom = torch.clamp_min(n_pos * n_neg, 1.0)
    aucs = (pos_rank_sum - n_pos * (n_pos + 1.0) / 2.0) / denom
    valid_k = (n_pos > 0) & (n_neg > 0)
    if present_only:
        n_valid = valid_k.float().sum()
        mean_auc = torch.where(valid_k, aucs, 0.0).sum() / torch.clamp_min(n_valid, 1.0)
        return torch.where(n_valid > 0, mean_auc, -1.0)
    return torch.where(valid_k.all(), aucs.mean(), -1.0)


def classification_metrics(
    labels: torch.Tensor, logits: torch.Tensor, num_class: int, auc_present_only: bool = False
) -> dict[str, torch.Tensor]:
    """loss / auc / accu / mcc / prec / recl / f1 as 0-d float32 tensors.
    Macro averages run over the classes present in labels or predictions."""
    labels = labels.long()
    loss = cross_entropy(logits, labels)
    probs = torch.softmax(logits.float(), dim=-1)
    auc = roc_auc_ovr(labels, probs, present_only=auc_present_only)
    preds = torch.argmax(probs, dim=-1)

    cm = torch.bincount(labels * num_class + preds, minlength=num_class * num_class)
    cm = cm.reshape(num_class, num_class).float()
    total = cm.sum()
    diag = torch.diagonal(cm)
    row = cm.sum(dim=1)  # true counts
    col = cm.sum(dim=0)  # predicted counts

    accu = diag.sum() / total
    c = diag.sum()
    num = c * total - (col * row).sum()
    den = torch.sqrt(total * total - (col**2).sum()) * torch.sqrt(total * total - (row**2).sum())
    mcc = torch.where(den > 0, num / torch.clamp_min(den, 1e-30), 0.0)

    present = (row > 0) | (col > 0)
    n_present = torch.clamp_min(present.float().sum(), 1.0)
    prec_k = torch.where(col > 0, diag / torch.clamp_min(col, 1.0), 0.0)
    recl_k = torch.where(row > 0, diag / torch.clamp_min(row, 1.0), 0.0)
    f1_k = torch.where(
        prec_k + recl_k > 0, 2.0 * prec_k * recl_k / torch.clamp_min(prec_k + recl_k, 1e-30), 0.0
    )
    prec = torch.where(present, prec_k, 0.0).sum() / n_present
    recl = torch.where(present, recl_k, 0.0).sum() / n_present
    f1 = torch.where(present, f1_k, 0.0).sum() / n_present
    return {"loss": loss, "auc": auc, "accu": accu, "mcc": mcc, "prec": prec, "recl": recl, "f1": f1}


def angular_distance(v1: torch.Tensor, v2: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(radian, degree) distances between unit vectors (N, 3); the dot
    product is clipped to [-1, 1] before the arccos."""
    dot = torch.clamp((v1 * v2).sum(dim=1), -1.0, 1.0)
    rad = torch.arccos(dot)
    return rad, torch.rad2deg(rad)


def cosine_embedding_loss(x1: torch.Tensor, x2: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """``CosineEmbeddingLoss`` with target 1: ``mean(1 - cos(x1, x2))`` over
    rows, the product of the norms floored at ``eps``."""
    n1 = torch.linalg.vector_norm(x1, dim=1)
    n2 = torch.linalg.vector_norm(x2, dim=1)
    cos = (x1 * x2).sum(dim=1) / torch.clamp_min(n1 * n2, eps)
    return (1.0 - cos).mean()


def iou_per_class(
    preds: torch.Tensor, targets: torch.Tensor, num_class: int = 4, eps: float = 1e-6
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-class IoU (num_class, B) and mean IoU (B,) of (B, H, W) maps."""
    cls = torch.arange(num_class, device=preds.device)[:, None, None, None]
    p = (preds[None] == cls).float()
    t = (targets[None] == cls).float()
    inter = (p * t).sum(dim=(2, 3))
    union = torch.clamp(p + t, 0.0, 1.0).sum(dim=(2, 3))
    ious = inter / (union + eps)
    return ious, ious.mean(dim=0)
