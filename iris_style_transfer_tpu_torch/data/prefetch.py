"""Aligned batching over same-length arrays or tensors.

Counterpart of ``iris_style_transfer_tpu/data/prefetch.py:batch_iterator``.
Tensors are indexed on their own device, so a device-resident dataset is
batched without a host round trip.
"""

from __future__ import annotations

from typing import Iterator, Sequence

import numpy as np
import torch


def _take(a, idx: np.ndarray):
    if isinstance(a, torch.Tensor):
        return a[torch.as_tensor(idx, device=a.device)]
    return a[idx]


def batch_iterator(arrays: Sequence, batch_size: int, pad_final: bool = True) -> Iterator[tuple]:
    """Yield aligned batch tuples in order.  A short final batch is padded
    by repeating its last row, with a boolean validity array appended as the
    last tuple element, or yielded short (``pad_final=False``).  Shuffling
    and dropping the remainder wait for the training mains."""
    n = len(arrays[0])
    idx = np.arange(n)
    for i in range(0, n, batch_size):
        take = idx[i : i + batch_size]
        if len(take) < batch_size:
            if pad_final:
                valid = np.zeros(batch_size, bool)
                valid[: len(take)] = True
                take = np.concatenate([take, np.full(batch_size - len(take), take[-1])])
                yield tuple(_take(a, take) for a in arrays) + (valid,)
                continue
        yield tuple(_take(a, take) for a in arrays)
