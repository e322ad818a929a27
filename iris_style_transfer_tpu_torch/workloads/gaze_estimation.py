"""Train the gaze estimators (OpenEDS2020), data-parallel.

Counterpart of ``iris_style_transfer_tpu/workloads/gaze_estimation.py``
(reference ``gaze_estimation.py``): GazeEstimator1 on the 19-d eye
landmarks, or GazeEstimator2 with a trainable ResNet50 trunk on the raw
400x640 frames (bf16 compute, f32 parameters and gradients); Adam on the
cosine embedding loss with target 1; an in-process sweep over the
learning rates (1e-6, 1e-5, 1e-4); per-epoch ``train/``, ``valid/`` (and,
with ``--test``, ``test/``) loss and angular distances; per-lr checkpoints
under the JAX package's directory names, with ``--resume``.  Flags are the
JAX workload's, plus ``--device``.

With ``--data_dir/openeds2020/openEDS2020-GazePrediction`` present the run
reads that OpenEDS2020 tree (``data/openeds2020.py``).  Estimator 1's
landmarks are extracted once per split, eagerly, by the B7 U-Net
(``--effnet_weights``, or the seeded init) on the device.  Estimator 2's
raw frames are streamed anew every epoch, in bounded memory: training
reshuffles with ``shuffle_seed = seed + epoch`` and drops the last short
batch; evaluation pads it and masks the padded rows out.  Without the tree
the run uses the synthetic gaze twin: 96 training frames and 32 validation
(and test) frames.  Every step drops the last short batch, so a batch size
above the training frames gives no step and the run stops with an error.

On a mesh (``--n_devices N``, or ``torchrun``; ``parallel/mesh.py``) every
rank walks the same global batches and trains on its block: the gradients
are averaged over the data group before Adam, the dropout masks are the
whole batch's, cut to the block, and the predictions are gathered.  All
BatchNorm on the path (ResNet50's) is in inference mode, as in JAX, so no
batch statistics need reducing.  Rank 0 alone logs and writes checkpoints.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch
import torch.utils._pytree as pytree

from ..data import (
    batch_iterator,
    load_data_openeds2020,
    load_labels_openeds2020,
    prefetch_to_device,
    stream_openeds2020,
    synthetic_eye_batch,
)
from ..models import EfficientNet, GazeEstimator1, GazeEstimator2, load_pretrained, pretrained_path
from ..ops.ellipse import extract_eye_landmarks
from ..ops.image import to_unit_float
from ..ops.metrics import angular_distance, cosine_embedding_loss
from ..parallel.mesh import Mesh, gather_batch, one_rank, pmean_grads, replicated
from ..runtime import MetricLogger, StepTimer, resume_training_state, save_training_state
from ..runtime.config import (
    WorkloadConfig,
    add_common_args,
    main_mesh,
    parse_config,
    resolve_device,
    run_on_ranks,
    spawns_ranks,
)
from ..utils import seed as seed_all
from .iris_classification import _sync, trainable

LRS = (1e-6, 1e-5, 1e-4)
N_TRAIN, N_EVAL = 96, 32  # synthetic frames per split


def _synthetic_gaze(n: int, estimator: int, seed: int = 0, device="cpu") -> tuple[np.ndarray, np.ndarray]:
    """(features, gaze) shaped like the 2020 loader's output: the 19-d
    landmarks of the twin's segmentation (estimator 1, extracted on
    ``device``) or its (N, 400, 640, 1) frames (estimator 2), and (N, 3)
    unit gaze vectors.  The twin's gaze is geometric, so the landmarks
    predict it."""
    imgs, segs, _, gaze = synthetic_eye_batch(n, seed=seed, gaze=True)
    if estimator == 1:
        return extract_eye_landmarks(torch.from_numpy(segs).to(device)).cpu().numpy(), gaze
    return imgs, gaze


def make_steps(estimator: int, compute_dtype=torch.float32, mesh: Mesh | None = None):
    """``train_step(params, opt, x, y, gen)`` and ``eval_step(params, x)``;
    dropout is on where ``gen`` is given.  Estimator 2 owns its ResNet50
    trunk and trains it (reference ``:56-59``).  With ``mesh``, ``x`` and
    ``y`` are this rank's block of the batch."""

    def forward(params, x, gen):
        x = to_unit_float(x)  # frames may stage as uint8
        train = gen is not None
        if estimator == 1:
            return GazeEstimator1.apply(params, x, train=train, gen=gen, mesh=mesh)
        return GazeEstimator2.apply(params, x, extract_feature=True, train=train, gen=gen,
                                    compute_dtype=compute_dtype, mesh=mesh)

    def train_step(params, opt, x, y, gen):
        o = forward(params, x, gen)
        loss = cosine_embedding_loss(o, y)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        if mesh is not None:
            pmean_grads(mesh, opt.param_groups[0]["params"])
        opt.step()
        return loss.detach(), o.detach()

    @torch.no_grad()
    def eval_step(params, x):
        return forward(params, x, None)

    return train_step, eval_step


def _epoch_metrics(preds: torch.Tensor, labels: torch.Tensor, prefix: str, log: dict) -> None:
    preds, labels = preds.float().cpu(), labels.float().cpu()
    log[f"{prefix}/loss"] = float(cosine_embedding_loss(preds, labels))
    rad, deg = angular_distance(preds, labels)
    log[f"{prefix}/radian_distance"] = float(rad.mean())
    log[f"{prefix}/degree_distance"] = float(deg.mean())


def gaze_estimation(cfg: WorkloadConfig, device: torch.device, lrs=LRS, effnet_weights: str = "",
                    resnet_weights: str = "", mesh: Mesh | None = None) -> dict:
    """Train the estimator over ``lrs``; ``mesh`` is the run's (None:
    ``device`` alone)."""
    mesh = mesh if mesh is not None else one_rank(device)
    seed_all(cfg.seed)
    base = os.path.join(cfg.data_dir, "openeds2020", "openEDS2020-GazePrediction")
    use_real = os.path.isdir(base)
    if not use_real:
        print(f"[data] {base} not found -> synthetic gaze twin")
    n_train = len(load_labels_openeds2020(base + "/", "train/")) if use_real else N_TRAIN
    if n_train < cfg.bs:
        raise SystemExit(f"{n_train} training frames give no step at -bs {cfg.bs} (the last short batch is "
                         f"dropped); use -bs {n_train} or less")
    if cfg.bs % mesh.shape["data"]:
        raise SystemExit(f"batch size {cfg.bs} not divisible by {mesh.shape['data']} data shards")
    compute_dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
    resnet_pre = None
    if cfg.estimator == 2 and (resnet_weights or pretrained_path("resnet50")):
        resnet_pre = load_pretrained("resnet50", resnet_weights, None, device)
    eff = None
    if use_real and cfg.estimator == 1:  # loaded once, for every split
        eff = load_pretrained("efficientnet_unet", effnet_weights,
                              lambda: EfficientNet.init(torch.Generator().manual_seed(0), device), device)

    def load(postfix: str):
        """A split as (features, gaze) arrays, or as its postfix when its
        raw frames are streamed (estimator 2 on the real tree)."""
        if use_real and cfg.estimator == 2:
            return postfix
        if use_real:
            return load_data_openeds2020(True, 1, base + "/", postfix, efficientnet_params=eff,
                                         compute_dtype=compute_dtype, device=device)
        return _synthetic_gaze(N_TRAIN if postfix == "train/" else N_EVAL, cfg.estimator, seed=cfg.seed,
                               device=device)

    def train_batches(split, epoch: int):
        if isinstance(split, str):
            return stream_openeds2020(base + "/", split, cfg.bs, shuffle_seed=cfg.seed + epoch, drop_remainder=True)
        return batch_iterator(split, cfg.bs, shuffle=True, seed=cfg.seed + epoch, drop_remainder=True)

    def eval_batches(split):
        if isinstance(split, str):
            return stream_openeds2020(base + "/", split, cfg.bs)
        return batch_iterator(split, cfg.bs)

    print("loading training set...")
    train = load("train/")
    print("loading validation set...")
    splits = [("valid", load("validation/"))] + ([("test", load("test/"))] if cfg.test else [])
    train_step, eval_step = make_steps(cfg.estimator, compute_dtype, mesh)

    final: dict = {}
    for lr in lrs:
        gen = seed_all(cfg.seed)
        kind = "model-based" if cfg.estimator == 1 else "appearance-based"
        logger = MetricLogger(cfg.project, f"seed {cfg.seed} {kind} lr {lr}", {**cfg.to_dict(), "lr": lr},
                              enabled=mesh.is_main)
        if cfg.estimator == 1:
            params = GazeEstimator1.init(gen, device=device)
        else:
            params = GazeEstimator2.init(gen, extract_feature=True, device=device)
            if resnet_pre is not None:  # reference resnet.py:18-21
                params["resnet"] = pytree.tree_map(torch.clone, resnet_pre)  # each lr starts afresh
        params = replicated(mesh, params)
        opt = torch.optim.Adam(trainable(params), lr=lr)
        timer = StepTimer()
        # seed-scoped, so --resume never restores another configuration's state
        ckpt_dir = f"saved/checkpoints/gaze_estimator{cfg.estimator}_lr_{lr}_seed_{cfg.seed}"
        start_epoch = resume_training_state(ckpt_dir, params, opt, mesh) if cfg.resume else 0
        if start_epoch:
            print(f"resumed lr {lr} from epoch {start_epoch}")

        drop_gen = torch.Generator(device=device)
        for e in range(start_epoch, cfg.epochs):
            log: dict = {}
            preds, labels = [], []
            for bi, batch in enumerate(prefetch_to_device(train_batches(train, e), device, mesh=mesh)):
                x, y = batch[0], batch[1]
                drop_gen.manual_seed(cfg.seed * 1_000_000_000 + e * 100_000 + bi)
                with timer:
                    _, o = train_step(params, opt, x, y, drop_gen)
                    _sync(device)
                preds.append(gather_batch(mesh, o))
                labels.append(gather_batch(mesh, y))
            _epoch_metrics(torch.cat(preds), torch.cat(labels), "train", log)

            for split_name, split in splits:
                preds, labels = [], []
                for batch in prefetch_to_device(eval_batches(split), device, mesh=mesh):
                    o, y = gather_batch(mesh, eval_step(params, batch[0])), gather_batch(mesh, batch[1])
                    if len(batch) > 2:  # the last batch's padded rows are masked out
                        valid = gather_batch(mesh, batch[2])
                        o, y = o[valid], y[valid]
                    preds.append(o)
                    labels.append(y)
                _epoch_metrics(torch.cat(preds), torch.cat(labels), split_name, log)

            log["train/steps_per_sec"] = timer.per_sec()
            logger.log(log)
            final = log
            if cfg.save_period > 0 and (e + 1) % cfg.save_period == 0:
                save_training_state(ckpt_dir, e + 1, params, opt, mesh)
        logger.finish()
    return final


def main(argv: list[str] | None = None):
    parser = argparse.ArgumentParser()
    defaults = WorkloadConfig(project="iris-style-transfer", epochs=150, bs=128, save_period=10)
    add_common_args(parser, defaults)
    parser.add_argument("--effnet_weights", type=str, default="",
                        help="ported smp Unet(efficientnet-b7) npz for estimator 1's landmark extraction")
    parser.add_argument("--resnet_weights", type=str, default="",
                        help="ported ResNet50 IMAGENET1K_V2 npz for GazeEstimator2's backbone")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to run on; a CUDA request without CUDA fails")
    cfg, args = parse_config(parser, defaults, argv)
    if cfg.estimator not in (1, 2):
        raise SystemExit(f"-estimator must be 1 or 2, got {cfg.estimator}")
    device = resolve_device(args.device)
    if cfg.model_parallel > 1:
        raise SystemExit("--model_parallel > 1: the gaze estimators have no tensor-parallel split (the JAX "
                         "main runs them on a data-only mesh); use --n_devices (ROADMAP §1 item 10)")
    if spawns_ranks(cfg):
        return run_on_ranks(main, argv, cfg, device)
    mesh = main_mesh(cfg, device)
    return gaze_estimation(cfg, mesh.device, effnet_weights=args.effnet_weights, resnet_weights=args.resnet_weights,
                           mesh=mesh)


if __name__ == "__main__":
    main()
