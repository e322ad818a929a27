"""One run of one cell: set-up, the measured pass, the traced slice, the
per-layer readers, the check against the reference, the result line.

Everything that belongs to one cell, configuration, traffic mix, entry
point or per-layer metric is a file found by its name:
``cells/<cell>.json`` names the configuration (``configs/<config>.json``),
the traffic mix (``traffic/<traffic>.json``) and the entry
(``entries/<entry>.py``, a class ``Entry``); ``BENCHMARK.json`` at the
root says which metrics the cell reports, and each per-layer metric is
read by ``metrics/<metric>.py`` (a function ``read(run)`` that returns a
number or None).  A later cell, configuration or metric is new files and
a new entry in ``BENCHMARK.json``, never an edit here.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
import time
from dataclasses import dataclass, field

import torch

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
FORBIDDEN = ("jax", "jaxlib", "flax", "iris_style_transfer_tpu")


def load_json(*parts: str) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's, compared whole (the port's name begins with the JAX
    package's)."""
    return sorted(k for k in list(sys.modules) if k.split(".")[0] in FORBIDDEN)


@dataclass
class Cell:
    name: str
    spec: dict
    config: dict
    traffic: dict

    @classmethod
    def load(cls, name: str) -> "Cell":
        spec = load_json(BENCH_DIR, "cells", f"{name}.json")
        return cls(name, spec, load_json(BENCH_DIR, "configs", f"{spec['config']}.json"),
                   load_json(BENCH_DIR, "traffic", f"{spec['traffic']}.json"))

    def metrics(self, kind: str) -> list[dict]:
        """The cell's ``end_to_end`` or ``per_layer`` metrics in BENCHMARK.json."""
        bench = load_json(ROOT, "BENCHMARK.json")
        return [m for m in bench[kind] if self.name in m.get("workloads", [self.name])]


@dataclass
class Run:
    """What a run hands its per-layer readers."""

    cell: Cell
    seed: int
    seconds: int
    device: torch.device
    entry: object = None
    setup_s: float = 0.0
    timed: dict = field(default_factory=dict)  # the measured pass: wall_s, images, batches, ...
    trace: object = None  # trace.Summary of the traced slice
    work: dict = field(default_factory=dict)  # the entry's per-batch work counts


def make_entry(run: Run):
    mod = load_module(os.path.join(BENCH_DIR, "entries", f"{run.cell.spec['entry']}.py"),
                      f"benchmark.entries.{run.cell.spec['entry']}")
    return mod.Entry(run)


def read_per_layer(run: Run) -> dict:
    out = {}
    for m in run.cell.metrics("per_layer"):
        reader = load_module(os.path.join(BENCH_DIR, "metrics", f"{m['name']}.py"), f"benchmark.metrics.{m['name']}")
        value = reader.read(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def checks(cell: Cell, readings: dict) -> list[tuple[str, float, float]]:
    """The readings the cell compares, each with its limit (``limits`` in
    the cell's file); a reading without a limit is not compared."""
    limits = cell.spec["limits"]
    return [(name, float(v), float(limits[name])) for name, v in readings.items() if name in limits]


def execute(cell: Cell, seed: int, seconds: int, trace: bool, t_start: float, device="cuda") -> dict:
    """The whole run; returns the result object (without printing it)."""
    run = Run(cell, seed, seconds, torch.device(device))
    entry = run.entry = make_entry(run)
    entry.setup()
    if run.device.type == "cuda":
        torch.cuda.synchronize()
    run.setup_s = time.perf_counter() - t_start
    from iris_style_transfer_tpu_torch.ops.cuda_build import BUILD_INFO

    built = sorted(k for k, v in BUILD_INFO.items() if v["seconds"] > 0)
    print(f"[setup] {run.setup_s:.3f} s; kernels built in this run: {', '.join(built) or 'none'}", flush=True)
    run.timed = entry.timed_pass()
    run.work = entry.work()
    if trace:
        run.trace = entry.traced_slice()
        metrics = read_per_layer(run)
    else:
        metrics = {"images_per_s": {"value": run.timed["images"] / run.timed["wall_s"], "unit": "images/s"},
                   "setup_s": {"value": run.setup_s, "unit": "s"}}
        wanted = {m["name"] for m in cell.metrics("end_to_end")}
        metrics = {k: v for k, v in metrics.items() if k in wanted}
    peak = torch.cuda.max_memory_allocated(run.device) if run.device.type == "cuda" else 0
    entry.release()
    readings = entry.judge()
    numbers = checks(cell, readings)
    device_info = {
        "platform": "gpu" if run.device.type == "cuda" else run.device.type,
        "kind": torch.cuda.get_device_name(run.device) if run.device.type == "cuda" else "cpu",
        "count": 1,
        "memory_peak_bytes": peak,
    }
    if trace:
        device_info.update(busy_s=run.trace.busy_s, window_s=run.trace.window_s)
    result = {
        "correct": all(v <= lim for _, v, lim in numbers),
        "attempted": run.timed["images"],
        "failed": 0,
        "metrics": metrics,
        "device": device_info,
    }
    if trace:
        result["breakdown"] = run.trace.breakdown
    result["not_compared"] = {k: v for k, v in readings.items() if k not in cell.spec["limits"]}
    result["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in numbers}
    return result
