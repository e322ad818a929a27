"""Metric logging with wandb-compatible namespaces to a local JSONL file.

Counterpart of ``iris_style_transfer_tpu/runtime/logging.py``; the same
keys (``test/pre/c2/mis/f1``, ...) so runs of the two packages compare
line for line.  wandb is used only when ``IST_TPU_WANDB=1`` and installed.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any


def _to_scalar(v):
    return v.item() if hasattr(v, "item") else v


class MetricLogger:
    """``enabled=False`` (the ranks other than 0 of a mesh) writes nothing
    and only counts the steps."""

    def __init__(self, project: str, name: str, config: dict | None = None,
                 out_dir: str = "saved/logs", use_wandb: bool | None = None, enabled: bool = True):
        self.project = project
        self.name = name
        self.step = 0
        self.enabled = enabled
        self._wandb = None
        if not enabled:
            return
        os.makedirs(out_dir, exist_ok=True)
        safe = name.replace("/", "_").replace(" ", "_")
        self.path = os.path.join(out_dir, f"{project}__{safe}.jsonl")
        self._fh = open(self.path, "a")
        if use_wandb is None:
            use_wandb = os.environ.get("IST_TPU_WANDB", "0") == "1"
        if use_wandb:
            try:
                import wandb
            except ImportError:
                wandb = None
            if wandb is not None:
                self._wandb = wandb
                wandb.init(project=project, name=name, config=config or {}, anonymous="allow")
        if config:
            self._fh.write(json.dumps({"_config": {k: str(v) for k, v in config.items()}}) + "\n")
            self._fh.flush()

    def log(self, metrics: dict[str, Any]) -> None:
        if not self.enabled:
            self.step += 1
            return
        rec = {k: _to_scalar(v) for k, v in metrics.items()}
        rec["_step"] = self.step
        rec["_time"] = time.time()
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()
        if self._wandb is not None:
            self._wandb.log({k: v for k, v in rec.items() if not k.startswith("_")})
        self.step += 1

    def finish(self) -> None:
        if not self.enabled:
            return
        self._fh.close()
        if self._wandb is not None:
            self._wandb.finish()
