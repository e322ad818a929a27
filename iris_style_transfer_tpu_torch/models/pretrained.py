"""Pretrained-weight loading for the workload mains.

Counterpart of ``iris_style_transfer_tpu/models/pretrained.py``: an
explicitly named npz (in the JAX package's format) wins, then the npz
auto-discovered under the JAX package's ``models/weights/`` directory
(read by path, under the JAX package's file names), then the seeded init.
"""

from __future__ import annotations

import os

from .port import from_jax, load_npz

WEIGHTS_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "iris_style_transfer_tpu", "models", "weights",
)
DEFAULT_NAMES = {
    "vgg19": "vgg19.npz",
    "resnet50": "resnet50.npz",
    "efficientnet_unet": "unet_efficientnet-b7.npz",
}


def pretrained_path(kind: str) -> str | None:
    """Auto-discovered npz path for ``kind``, or None when absent."""
    path = os.path.join(WEIGHTS_DIR, DEFAULT_NAMES[kind])
    return path if os.path.exists(path) else None


def load_pretrained(kind: str, explicit_path: str = "", init_fn=None, device="cpu"):
    """Torch-layout params for ``kind`` from a ported npz, or ``init_fn()``."""
    if explicit_path:
        if not os.path.exists(explicit_path):
            raise FileNotFoundError(f"{kind} weights not found: {explicit_path}")
        print(f"[weights] {kind} <- {explicit_path}")
        return from_jax(load_npz(explicit_path), device=device)
    path = pretrained_path(kind)
    if path is not None:
        print(f"[weights] {kind} <- {path} (auto-discovered)")
        return from_jax(load_npz(path), device=device)
    if init_fn is None:
        raise FileNotFoundError(f"no pretrained weights for {kind} and no fallback")
    print(f"[weights] {kind}: no ported npz found -> seeded init (structural run)")
    return init_fn()
