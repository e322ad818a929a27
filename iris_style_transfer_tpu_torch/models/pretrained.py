"""Pretrained-weight loading for the workload mains.

Counterpart of ``iris_style_transfer_tpu/models/pretrained.py``: an
explicitly named npz (in the JAX package's format) wins, then the npz
auto-discovered under the JAX package's ``models/weights/`` directory
(read by path, under the JAX package's file names), then the seeded init.
An auto-discovered npz is checked against the ``npz_sha256`` that
``tools/weights_manifest.json`` records for its kind, as the JAX package
checks it: the manifest is read, by path, and never written here.
"""

from __future__ import annotations

import hashlib
import json
import os

from .port import from_jax, load_npz

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
WEIGHTS_DIR = os.path.join(_REPO, "iris_style_transfer_tpu", "models", "weights")
MANIFEST_PATH = os.path.join(_REPO, "tools", "weights_manifest.json")
DEFAULT_NAMES = {
    "vgg19": "vgg19.npz",
    "resnet50": "resnet50.npz",
    "efficientnet_unet": "unet_efficientnet-b7.npz",
}


def pretrained_path(kind: str) -> str | None:
    """Auto-discovered npz path for ``kind``, or None when absent."""
    path = os.path.join(WEIGHTS_DIR, DEFAULT_NAMES[kind])
    return path if os.path.exists(path) else None


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def _manifest_entry(kind: str) -> dict | None:
    try:
        with open(MANIFEST_PATH) as f:
            manifest = json.load(f)
    except (OSError, ValueError):
        return None
    for a in manifest.get("artifacts", []):
        if a.get("kind") == kind:
            return a
    return None


def verify_manifest_checksum(kind: str, path: str) -> None:
    """Raise if ``path`` differs from the ``npz_sha256`` the manifest
    records for ``kind`` (the JAX package's check, message and all); an
    entry without a recorded checksum passes."""
    want = (_manifest_entry(kind) or {}).get("npz_sha256")
    if not want:
        return
    got = _sha256(path)
    if got != want:
        raise ValueError(
            f"{kind} weights at {path} fail the manifest checksum "
            f"(sha256 {got[:12]}… != recorded {want[:12]}…). Re-port with "
            "tools/fetch_and_port.sh, or update tools/weights_manifest.json "
            "if the npz was replaced deliberately."
        )


def load_pretrained(kind: str, explicit_path: str = "", init_fn=None, device="cpu"):
    """Torch-layout params for ``kind`` from a ported npz, or ``init_fn()``."""
    if explicit_path:
        if not os.path.exists(explicit_path):
            raise FileNotFoundError(f"{kind} weights not found: {explicit_path}")
        print(f"[weights] {kind} <- {explicit_path}")
        return from_jax(load_npz(explicit_path), device=device)
    path = pretrained_path(kind)
    if path is not None:
        verify_manifest_checksum(kind, path)
        print(f"[weights] {kind} <- {path} (auto-discovered)")
        return from_jax(load_npz(path), device=device)
    if init_fn is None:
        raise FileNotFoundError(f"no pretrained weights for {kind} and no fallback")
    print(f"[weights] {kind}: no ported npz found -> seeded init (structural run)")
    return init_fn()
