"""The mechanics of an IST sweep, which both IST mains run.

An IST main (``ist_openeds2019.py``, ``ist_openeds2020.py``) keeps its
programs, per-batch metric jobs, epoch-end metrics and arrays, flags and
data.  :class:`Sweep` walks one combo's batches and hands the metric jobs
to one worker thread, overlapped with the next batch's device work;
:func:`sweep_main` is the part of ``main()`` both mains share, and
:func:`run_combos` walks a split's combos.

Each sweep is a run of ``runtime/profiler.py``'s spans, which cost one
check each while no profiler records: ``ist.load``, ``ist.pre``,
``ist.nst``, ``ist.nst_sync``, ``ist.post``, ``ist.save`` and
``ist.metric_job`` a batch, beside the main's own, then ``ist.drain`` and
``ist.aggregate``.

On a mesh (``--n_devices N``, or ``torchrun``; ``parallel/mesh.py``) every
rank walks the same global batches and runs the main's programs, the joint
NST (its L-BFGS reduced over the data group) and the composite on its
block; what the metrics read is gathered, and rank 0 alone writes logs,
PNGs, arrays and ``done.json``.  ``--model_parallel m`` (JAX's spatial
sharding) makes the mesh (n/m data, m model): the programs and the
composite run on the rank's data block, repeated over its model group; the
NST runs on the rank's slab of H rows of that block (its L-BFGS reduced
over every rank), and one gather over the model group restores the whole
stylized irises.  ``(224 / 8) % m`` must be 0, as in JAX.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import itertools
import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..parallel.mesh import Mesh, barrier, gather_height
from ..runtime import MetricLogger, StepTimer, WorkloadConfig, add_common_args, parse_config
from ..runtime.config import check_model_parallel, main_mesh, resolve_device, run_on_ranks, spawns_ranks
from ..runtime.profiler import at_batch, job, new_run, span, sync
from ..utils import prepare_dir, save_png, sweep_done, write_sweep_marker

CROP = (224, 224)  # the NST's iris crop


def _loss_job(metric_prefix, c_hist, s_hist, c_w, s_w):
    c_loss, s_loss = float(c_hist[-1].item()), float(s_hist[-1].item())
    log = {
        f"{metric_prefix}/batch/c_loss": c_loss,
        f"{metric_prefix}/batch/s_loss": s_loss,
        f"{metric_prefix}/batch/cs_loss": c_loss * c_w + s_loss * s_w,
    }
    return log, {"c_loss": c_loss, "s_loss": s_loss}


class Sweep:
    """One sweep combo's batch loop, metric worker and drain.  A metric job
    returns (its log entries, its aggregates); the drain appends the
    aggregates to ``agg``, where the body may append its own."""

    def __init__(self, mesh: Mesh, device: torch.device, metric_prefix: str, save_dir: str, save_period: int,
                 c_loss_weight: float, s_loss_weight: float):
        self.mesh, self.device, self.metric_prefix = mesh, device, metric_prefix
        self.save_dir, self.save_period = save_dir, save_period
        self.weights = (c_loss_weight, s_loss_weight)
        self.timer = StepTimer()
        self.agg: dict[str, list] = collections.defaultdict(list)
        self.pipe_times: list[float] = []
        self.t_drain = 0.0
        self.batch_id = None
        self._pool = self._futs = None

    def run(self, batches, unpack, body, logger: MetricLogger) -> dict[str, list]:
        """``body(*unpack(batch))`` for each batch, the fetch and ``unpack``
        under ``ist.load``; then the drain, one record a batch.  Returns ``agg``."""
        pending = []
        self._pool = ThreadPoolExecutor(max_workers=1)
        new_run()
        batches = iter(batches)
        try:
            for self.batch_id in itertools.count():
                at_batch(self.batch_id)
                with span("ist.load"):
                    batch = next(batches, None)
                    t_batch = time.perf_counter()
                    parts = None if batch is None else unpack(batch)
                if batch is None:
                    break
                self._futs = []
                body(*parts)
                pending.append(self._futs)
                self.pipe_times.append(time.perf_counter() - t_batch)

            # drain in batch order; the drain's wall time counts against the
            # end-to-end throughput (:meth:`rates`)
            at_batch(None)
            with span("ist.drain"):
                t_drain0 = time.perf_counter()
                for futs in pending:
                    blog = {}
                    for f in futs:
                        log_upd, agg_upd = f.result()
                        blog.update(log_upd)
                        for k, v in agg_upd.items():
                            self.agg[k].append(v)
                    logger.log(blog)
                self.t_drain = time.perf_counter() - t_drain0
        finally:
            self._pool.shutdown(wait=True)
        return self.agg

    def submit(self, fn, *args) -> None:
        """``fn(*args)`` to the metric worker, in the batch's record."""
        self._futs.append(self._pool.submit(job("ist.metric_job", fn), *args))

    @contextlib.contextmanager
    def nst(self, call):
        """``call()``, the NST program on this rank's rows, timed to the
        device's end: ``ist.nst`` around it and the gather of the stylized
        irises, ``ist.nst_sync`` around the synchronize.  The block, given
        the stylized irises, runs under ``ist.post`` once the NST's losses
        are handed to the worker."""
        with self.timer:
            with span("ist.nst"):
                result = call()
                stylized = gather_height(self.mesh, result.x)
            with span("ist.nst_sync"):
                sync(self.device)
        with span("ist.post"):
            self.submit(_loss_job, self.metric_prefix, result.c_loss_hist, result.s_loss_hist, *self.weights)
            yield stylized

    def save(self, **images) -> None:
        """Every ``save_period``-th batch, on rank 0 (whose block starts the
        batch), the first frame of each ``images`` as ``batch_<id>_<name>.png``."""
        if self.batch_id % self.save_period == 0 and self.mesh.is_main:
            with span("ist.save"):
                for name, frames in images.items():
                    frame = frames[0]
                    save_png(f"{self.save_dir}batch_{self.batch_id}_{name}.png",
                             frame.cpu().numpy() if torch.is_tensor(frame) else frame)

    def loss_means(self) -> dict[str, float]:
        """The sweep's mean content, style and weighted losses."""
        c_loss, s_loss = float(np.nanmean(self.agg["c_loss"])), float(np.nanmean(self.agg["s_loss"]))
        c_w, s_w = self.weights
        p = self.metric_prefix
        return {f"{p}/c_loss": c_loss, f"{p}/s_loss": s_loss, f"{p}/cs_loss": c_loss * c_w + s_loss * s_w}

    def rates(self, bs: int) -> dict[str, float]:
        """The NST's batches a second and images a minute, and end to end
        the images a minute of the batches and drain; each without the first
        (warm-up) batch when there are more."""
        out = {"nst_batches_per_sec": self.timer.per_sec(), "stylized_images_per_min": self.timer.per_sec(bs) * 60}
        pipe = self.pipe_times[1:] if len(self.pipe_times) > 1 else self.pipe_times
        if pipe:
            out["pipeline_images_per_min"] = bs * len(pipe) / (sum(pipe) + self.t_drain) * 60
        return out


def sweep_main(main, argv, parser: argparse.ArgumentParser, defaults: WorkloadConfig, sweeps):
    """``main(argv)`` of an IST main whose own flags ``parser`` holds: a run
    that asks for more ranks than it has is spawned on them, each running
    ``main``, and returns rank 0's result; else ``sweeps(cfg, args, mesh)``."""
    add_common_args(parser, defaults)
    parser.add_argument("--vgg_weights", type=str, default="",
                        help="ported VGG19 IMAGENET1K_V1 npz in the JAX package's format")
    parser.add_argument("--nst_epochs", type=int, nargs="+", default=[200])
    parser.add_argument("--s_loss_weights", type=float, nargs="+", default=[1.0])
    parser.add_argument("--rerun", action="store_true",
                        help="re-run sweep combos that already have a done.json marker")
    cfg, args = parse_config(parser, defaults, argv)
    device = resolve_device(args.device)
    check_model_parallel(cfg.model_parallel, CROP[0])
    if spawns_ranks(cfg, device):
        return run_on_ranks(main, argv, cfg, device)
    mesh = main_mesh(cfg, device)
    if cfg.bs % mesh.batch_shards:
        raise SystemExit(f"batch size {cfg.bs} not divisible by {mesh.batch_shards} data shards")
    return sweeps(cfg, args, mesh)


def run_combos(cfg: WorkloadConfig, args, mesh: Mesh, dataset: str, split: str, name: str, run, **inputs) -> dict:
    """``run(sw, nst_epoch, save_dir, logger)``, which returns its log, for
    each combo of ``split`` whose ``done.json`` does not record this run's
    config and ``inputs`` (any, with ``--rerun``); rank 0 makes the
    directory, logs and writes the marker.  Returns the logs by
    (split, sw, nst_epoch)."""
    presentation = {"name", "project", "num_workers", "resume", "save_period"}
    sweep_config = {k: v for k, v in cfg.to_dict().items() if k not in presentation} | inputs
    results = {}
    for sw in args.s_loss_weights:
        for nst_epoch in args.nst_epochs:
            save_dir = f"saved/{dataset}/sw_{sw}_epoch_{nst_epoch}/{split}"
            done_marker = os.path.join(save_dir, "done.json")
            barrier(mesh)  # rank 0's markers are written before any rank reads them
            if sweep_done(done_marker, sweep_config, defaults=WorkloadConfig().to_dict()) and not args.rerun:
                print(f"[sweep] {save_dir} already complete, skipping")
                continue
            if mesh.is_main:
                prepare_dir(save_dir, idempotent=True)
            logger = MetricLogger(cfg.project, f"seed {cfg.seed} sw {sw} epoch {nst_epoch} {name}", cfg.to_dict(),
                                  enabled=mesh.is_main)
            log = run(sw, nst_epoch, save_dir, logger)
            logger.finish()
            if mesh.is_main:
                write_sweep_marker(done_marker, sweep_config, log)
            results[(split, sw, nst_epoch)] = log
    return results
