"""Typed workload config with the reference's CLI flag names.

Counterpart of ``iris_style_transfer_tpu/runtime/config.py``; the same
dataclass and flags, so a command line of the JAX workload parses here.
``--n_devices N > 1`` runs a main data-parallel on N ranks
(:func:`spawns_ranks`, :func:`run_on_ranks`, :func:`main_mesh`); under
``torchrun`` the launcher's environment says the ranks instead.
``--n_devices 0``, the default, means every device, as in the JAX
package: on a CUDA device outside a process group the main spawns one
rank per visible card (``torch.cuda.device_count()``) when there are two
or more, and runs as one process on one card; on the CPU it is one
process.
``--scan_unroll`` only shapes the TPU program and has no effect here.  Nor
does ``--pallas_gram``: the
IST mains never use the Gram loss, and on a CUDA device the Gram always
runs the hand-written kernel (``ops/blockwise_gram.py``).
``--stats_taps on`` takes the fused relu+stats style taps
(``ops/relu_stats.py``); "auto" means off, as the JAX package's
``layers.STATS_TAPS = False`` makes it there.
``--model_parallel m`` makes a ``(data, model)`` mesh of n/m by m ranks:
the IST mains split each NST image's H over the model ranks
(``parallel/mesh.py:spatial_sharding``; :func:`check_model_parallel`), the
classifier trainer splits its heads over them, and the gaze trainer runs
data-parallel only, as the JAX mains do.
"""

from __future__ import annotations

import argparse
import functools
import os
import sys
from dataclasses import asdict, dataclass

import torch
import torch.distributed as dist

from ..parallel.mesh import SPATIAL_POOLS, Mesh, make_mesh, run_ranks


def resolve_device(name: str) -> torch.device:
    """The device a run asks for; a CUDA request without CUDA raises."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {name} was requested but CUDA is not available")
    return device


@dataclass
class WorkloadConfig:
    project: str = "iris-style-transfer"
    seed: int = 42
    epochs: int = 500
    test_split_ratio: float = 0.2
    bs: int = 64
    lr: float = 1e-5
    save_period: int = 50
    rotation_prob: float = 0.0
    rotation_degree: float = 180.0
    perspect_prob: float = 0.0
    perspect_degree: float = 0.3
    freeze_vgg: bool = True
    c_loss_weight: float = 1.0
    s_loss_weight: float = 1.0
    nst_epochs: int = 200
    glint_threshold: float = 0.8
    eval_train: bool = False
    eval_test: bool = False
    estimator: int = 1
    test: bool = False
    num_workers: int = 16
    model_parallel: int = 1
    n_devices: int = 0
    compute_dtype: str = "bfloat16"
    data_dir: str = "../data"
    resume: bool = False
    name: str = ""
    scan_unroll: int = 8
    history_size: int = 10
    pallas_gram: str = "auto"
    stats_taps: str = "auto"

    def to_dict(self) -> dict:
        return asdict(self)


def add_common_args(parser: argparse.ArgumentParser, defaults: WorkloadConfig) -> None:
    """Register the reference's flags (same short names), the JAX
    package's knobs and the port's ``--device``."""
    p = parser
    p.add_argument("-P", "--project", type=str, default=defaults.project)
    p.add_argument("-seed", "--seed", type=int, default=defaults.seed)
    p.add_argument("-E", "--epochs", type=int, default=defaults.epochs)
    p.add_argument("-T", "--test_split_ratio", type=float, default=defaults.test_split_ratio)
    p.add_argument("-bs", "--bs", type=int, default=defaults.bs)
    p.add_argument("-lr", "--lr", type=float, default=defaults.lr)
    p.add_argument("-SP", "--save_period", type=int, default=defaults.save_period)
    p.add_argument("-rp", "--rotation_prob", type=float, default=defaults.rotation_prob)
    p.add_argument("-rd", "--rotation_degree", type=float, default=defaults.rotation_degree)
    p.add_argument("-pp", "--perspect_prob", type=float, default=defaults.perspect_prob)
    p.add_argument("-pd", "--perspect_degree", type=float, default=defaults.perspect_degree)
    p.add_argument("-cw", "--c_loss_weight", type=float, default=defaults.c_loss_weight)
    p.add_argument("--glint_threshold", type=float, default=defaults.glint_threshold)
    p.add_argument("--freeze_vgg", action=argparse.BooleanOptionalAction, default=defaults.freeze_vgg)
    p.add_argument("--eval_train", action=argparse.BooleanOptionalAction, default=defaults.eval_train)
    p.add_argument("--eval_test", action=argparse.BooleanOptionalAction, default=defaults.eval_test)
    p.add_argument("-estimator", "--estimator", type=int, default=defaults.estimator)
    p.add_argument("--test", action=argparse.BooleanOptionalAction, default=defaults.test)
    p.add_argument("-W", "--num_workers", type=int, default=defaults.num_workers)
    p.add_argument("--model_parallel", type=int, default=defaults.model_parallel)
    p.add_argument("--n_devices", type=int, default=defaults.n_devices)
    p.add_argument("--compute_dtype", type=str, default=defaults.compute_dtype)
    p.add_argument("--data_dir", type=str, default=defaults.data_dir)
    p.add_argument("--resume", action=argparse.BooleanOptionalAction, default=defaults.resume)
    p.add_argument("--scan_unroll", type=int, default=defaults.scan_unroll)
    p.add_argument("--history_size", type=int, default=defaults.history_size)
    p.add_argument("--pallas_gram", type=str, choices=("auto", "on", "off"), default=defaults.pallas_gram)
    p.add_argument("--stats_taps", type=str, choices=("auto", "on", "off"), default=defaults.stats_taps)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on; a CUDA request without CUDA fails")


def parse_config(parser: argparse.ArgumentParser, defaults: WorkloadConfig, argv=None):
    """Parse once; returns ``(cfg, args)`` so mains read their extra flags
    from the same parse."""
    args = parser.parse_args(argv)
    cfg = WorkloadConfig(**{k: getattr(args, k) for k in defaults.to_dict() if hasattr(args, k)})
    return cfg, args


def _in_process_group() -> bool:
    return dist.is_initialized() or "WORLD_SIZE" in os.environ


def _ranks(cfg: WorkloadConfig, device: torch.device) -> int:
    """The ranks a run asks for: ``--n_devices``, or with 0 every visible
    card of a CUDA device (one on the CPU)."""
    if cfg.n_devices == 0 and device.type == "cuda":
        return torch.cuda.device_count()
    return cfg.n_devices


def spawns_ranks(cfg: WorkloadConfig, device: torch.device) -> bool:
    """True when the run asks for more than one rank (``--n_devices N > 1``,
    or ``--n_devices 0`` on a CUDA device with two or more visible cards)
    and no process group or launcher provides them: the main then runs
    itself on that many spawned ranks."""
    return not _in_process_group() and _ranks(cfg, device) > 1


def run_on_ranks(main, argv, cfg: WorkloadConfig, device: torch.device):
    """``main(argv)`` on the ranks :func:`spawns_ranks` counts, spawned on
    this host (one card each, or all on the CPU); returns rank 0's result."""
    argv = list(sys.argv[1:] if argv is None else argv)
    n = _ranks(cfg, device)
    devices = None if device.type == "cuda" else [device] * n
    return run_ranks(functools.partial(main, argv), n, devices=devices)


def check_model_parallel(model_parallel: int, height: int) -> None:
    """Stop an IST main whose ``--model_parallel`` cannot split its NST
    images' ``height``: every VGG19 tap down to relu4_1 must split over the
    model ranks, ``(height / 8) % model_parallel == 0``
    (``parallel/mesh.py:height_sharding``), with the JAX mains' message."""
    rows = height // 2**SPATIAL_POOLS
    if model_parallel > 1 and rows % model_parallel:
        ok = [str(d) for d in range(2, rows + 1) if rows % d == 0]
        raise SystemExit(f"model_parallel={model_parallel} must divide the relu4_1 tap height {height}/8={rows} "
                         f"(use {', '.join(ok[:-1])} or {ok[-1]})")


def main_mesh(cfg: WorkloadConfig, device: torch.device) -> Mesh:
    """The mesh a main runs on: one rank on ``device`` outside a process
    group; inside one, its ranks, each on its own card (``cuda:LOCAL_RANK``)
    or all on the CPU.  A mesh the ranks cannot form stops the run."""
    if _in_process_group():
        world = dist.get_world_size() if dist.is_initialized() else int(os.environ["WORLD_SIZE"])
        devices = None if device.type == "cuda" else [device] * world
    else:
        devices = [device]
    try:
        return make_mesh(cfg.n_devices or None, cfg.model_parallel, devices=devices)
    except ValueError as e:
        raise SystemExit(f"{e}: pass --n_devices N, or run the main under torchrun "
                         "(README, data parallelism; ROADMAP §1 item 10)") from None
