"""Weight bridge between the JAX package's parameter pytrees and torch
tensors, both ways.

:func:`from_jax` is the inverse of ``iris_style_transfer_tpu/models/port.py``:
HWIO conv kernels become OIHW, (in, out) linear weights become (out, in),
and batchnorm ``{scale, bias, mean, var}`` leaves carry over unchanged.
:func:`to_jax` inverts :func:`from_jax`, so the port's checkpoints are
written in the JAX layout.  The npz reader and writer use the JAX package's
flattened key format (``'/'``-joined paths, all-digit segments for list
entries), so ``models/weights/ritnet.npz``, any ported ``--vgg_weights``
npz and the checkpoints of either package load without JAX.
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


def _jax_leaf(key: str, t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        a = (t.float() if t.dtype == torch.bfloat16 else t).numpy()  # numpy has no bfloat16
    else:
        a = np.asarray(t)
    if key == "w" and a.ndim == 4:
        a = np.transpose(a, (2, 3, 1, 0))  # OIHW -> HWIO
    elif key == "w" and a.ndim == 2:
        a = np.transpose(a, (1, 0))  # (out, in) -> (in, out)
    return np.asarray(a, order="C")  # keeps 0-d leaves 0-d


def to_jax(params):
    """The inverse of :func:`from_jax`: a torch-layout tree (nested dicts /
    lists of tensors) as the same tree of numpy arrays in JAX layout."""

    def walk(node, key):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v, key) for v in node]
        return _jax_leaf(key, node)

    return walk(params, "")


def flatten_pytree(tree, prefix: str = "") -> dict[str, np.ndarray]:
    """Nested dicts / lists -> '/'-joined flat keys (list entries as
    all-digit segments), the JAX package's npz key format."""
    flat = {}
    items = enumerate(tree) if isinstance(tree, (list, tuple)) else tree.items()
    for k, v in items:
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, (dict, list, tuple)):
            flat.update(flatten_pytree(v, key))
        else:
            flat[key] = np.asarray(v)
    return flat


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
