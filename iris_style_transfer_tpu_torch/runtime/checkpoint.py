"""Parameter restore from the JAX package's npz checkpoints.

Counterpart of ``iris_style_transfer_tpu/runtime/checkpoint.py:restore_params``:
an exact file loads that file, a directory loads its latest
``step_*.npz``, an empty path returns ``default``, a named but missing path
raises.  The ``params`` subtree is converted to torch layout.
"""

from __future__ import annotations

import os
import re

from ..models.port import from_jax, load_npz


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(m.group(1)) for f in os.listdir(ckpt_dir) if (m := re.match(r"step_(\d+)\.npz$", f))]
    return max(steps) if steps else None


def restore_params(path: str | None, default=None, device="cpu"):
    if not path:
        return default
    if not os.path.isfile(path):
        step = latest_step(path)
        if step is None:
            raise FileNotFoundError(f"checkpoint not found: {path}")
        path = os.path.join(path, f"step_{step:08d}.npz")
    return from_jax(load_npz(path)["params"], device=device)
