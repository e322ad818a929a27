"""Seeding, output directories and sweep markers.

Counterpart of ``iris_style_transfer_tpu/utils/misc.py``.  :func:`seed`
seeds the host RNGs (dataset splits and donor sampling) and returns a CPU
``torch.Generator`` for seeded parameter init; ``prepare_dir``,
``sweep_done`` and ``write_sweep_marker`` keep sweeps resumable;
``save_png`` writes the sample images the workloads keep (``utils/png.py``).
"""

from __future__ import annotations

import json
import os
import random
import shutil

import numpy as np
import torch

from .png import write_png


def seed(seed_value: int = 42, verbose: bool = True) -> torch.Generator:
    """Seed host RNGs and return a seeded CPU ``torch.Generator``."""
    if verbose:
        print("\nrandom seed:", seed_value)
    np.random.seed(seed_value)
    random.seed(seed_value)
    return torch.Generator().manual_seed(seed_value)


def prepare_dir(path: str, idempotent: bool = False) -> None:
    """Create an output directory; without ``idempotent`` an existing one is
    wiped first (reference ``utils.py:32-42``)."""
    if os.path.isdir(path):
        if idempotent:
            return
        shutil.rmtree(path)
    os.makedirs(path)


def save_png(path: str, img: np.ndarray) -> None:
    """Write an (H, W), (H, W, 1) or (H, W, 3) image as an 8-bit PNG; floats
    are taken as [0,1] (``utils/png.py``, no imaging library needed)."""
    write_png(path, img)


def sweep_done(marker_path: str, config: dict, defaults: dict | None = None) -> bool:
    """True if a completion marker exists and was written under the same
    configuration; config keys added since then do not invalidate it while
    they hold their defaults."""
    if not os.path.exists(marker_path):
        return False
    try:
        with open(marker_path) as fh:
            data = json.load(fh)
    except (json.JSONDecodeError, OSError):
        return False
    stored = data.get("config")
    if stored == config:
        return True
    if defaults and isinstance(stored, dict):
        added = {k: v for k, v in config.items() if k not in stored}
        if added and all(k in defaults and defaults[k] == v for k, v in added.items()):
            return {k: v for k, v in config.items() if k in stored} == stored
    return False


def write_sweep_marker(marker_path: str, config: dict, metrics: dict) -> None:
    """Write done.json with the combo's metrics and its configuration."""
    with open(marker_path, "w") as fh:
        json.dump({"config": config, "metrics": {k: float(v) for k, v in metrics.items()}}, fh)
