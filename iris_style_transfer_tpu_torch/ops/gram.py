"""Gram matrices for style features.

Counterpart of ``iris_style_transfer_tpu/ops/gram.py``.  Features are NCHW
here; the contraction is one batched matmul in float32.  This is the plain
version of the hand-written Gram kernel (``ops/blockwise_gram.py``, the
counterpart of the JAX package's ``ops/pallas_gram.py``): the kernel is
held against it on the card, and a CPU tensor takes it.
"""

from __future__ import annotations

import torch


def gram_matrix(x: torch.Tensor, batched_norm: bool = True) -> torch.Tensor:
    """Normalized Gram matrix of (B, C, H, W) features -> (B, C, C) float32.

    ``batched_norm=True`` normalizes by C*H*W (the reference's batched
    convention); ``False`` by H*W.
    """
    b, c, h, w = x.shape
    flat = x.float().reshape(b, c, h * w)
    g = torch.bmm(flat, flat.transpose(1, 2))
    n = (c * h * w) if batched_norm else (h * w)
    return g / n
