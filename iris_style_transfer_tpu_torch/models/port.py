"""Weight bridge from the JAX package's parameter pytrees to torch tensors.

The inverse of ``iris_style_transfer_tpu/models/port.py``: HWIO conv
kernels become OIHW, (in, out) linear weights become (out, in), and
batchnorm ``{scale, bias, mean, var}`` leaves carry over unchanged.  The
npz reader understands the JAX package's flattened key format
(``'/'``-joined paths, all-digit segments for list entries), so
``models/weights/ritnet.npz`` and any ported ``--vgg_weights`` npz load
without JAX.
"""

from __future__ import annotations

import numpy as np
import torch


def _leaf(key: str, a, device, dtype) -> torch.Tensor:
    a = np.asarray(a)
    if key == "w" and a.ndim == 4:
        a = np.transpose(a, (3, 2, 0, 1))  # HWIO -> OIHW
    elif key == "w" and a.ndim == 2:
        a = np.transpose(a, (1, 0))  # (in, out) -> (out, in)
    t = torch.from_numpy(np.array(a, order="C"))  # a writable copy
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def from_jax(params, device="cpu", dtype=None):
    """Convert a JAX-layout parameter tree (nested dicts / lists of numpy
    arrays) into the same tree of torch tensors in torch layout."""

    def walk(node, key):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v, key) for v in node]
        return _leaf(key, node, device, dtype)

    return walk(params, "")


def unflatten_pytree(flat: dict) -> dict:
    """'/'-joined flat keys -> nested dicts; all-digit levels become lists."""
    tree: dict = {}
    for k, v in flat.items():
        parts = k.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v

    def listify(node):
        if not isinstance(node, dict):
            return node
        if node and all(key.isdigit() for key in node):
            return [listify(node[key]) for key in sorted(node, key=int)]
        return {k: listify(v) for k, v in node.items()}

    return listify(tree)


def load_npz(path: str) -> dict:
    """Read an npz written by the JAX package's ``save_npz`` into its
    (numpy, JAX-layout) tree; convert with :func:`from_jax`."""
    with np.load(path) as f:
        return unflatten_pytree({k: f[k] for k in f.files})
