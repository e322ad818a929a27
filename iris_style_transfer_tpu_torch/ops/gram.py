"""Gram matrices for style features.

Counterpart of ``iris_style_transfer_tpu/ops/gram.py``.  Features are NCHW
here; the contraction is one batched matmul in float32.  The JAX package's
Pallas Gram kernel (``ops/pallas_gram.py``) is not ported yet — this is the
plain form it is held against (ROADMAP, TPU kernels still to port).
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
