"""Train the gaze estimators (OpenEDS2020), on one device.

Counterpart of ``iris_style_transfer_tpu/workloads/gaze_estimation.py``
(reference ``gaze_estimation.py``): GazeEstimator1 on the 19-d eye
landmarks, or GazeEstimator2 with a trainable ResNet50 trunk on the raw
400x640 frames (bf16 compute, f32 parameters and gradients); Adam on the
cosine embedding loss with target 1; an in-process sweep over the
learning rates (1e-6, 1e-5, 1e-4); per-epoch ``train/``, ``valid/`` (and,
with ``--test``, ``test/``) loss and angular distances; per-lr checkpoints
under the JAX package's directory names, with ``--resume``.  Flags are the
JAX workload's, plus ``--device``.

Without ``--data_dir/openeds2020/openEDS2020-GazePrediction`` the run uses
the synthetic gaze twin: 96 training frames and 32 validation (and test)
frames.  Every step drops the last short batch, so a batch size above 96
gives no training step there and the run stops with an error.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch
import torch.utils._pytree as pytree

from ..data import batch_iterator, prefetch_to_device, synthetic_eye_batch
from ..models import GazeEstimator1, GazeEstimator2, load_pretrained, pretrained_path
from ..ops.ellipse import extract_eye_landmarks
from ..ops.image import to_unit_float
from ..ops.metrics import angular_distance, cosine_embedding_loss
from ..runtime import MetricLogger, StepTimer, resume_training_state, save_training_state
from ..runtime.config import WorkloadConfig, add_common_args, parse_config, resolve_device
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


def make_steps(estimator: int, compute_dtype=torch.float32):
    """``train_step(params, opt, x, y, gen)`` and ``eval_step(params, x)``;
    dropout is on where ``gen`` is given.  Estimator 2 owns its ResNet50
    trunk and trains it (reference ``:56-59``)."""

    def forward(params, x, gen):
        x = to_unit_float(x)  # frames may stage as uint8
        train = gen is not None
        if estimator == 1:
            return GazeEstimator1.apply(params, x, train=train, gen=gen)
        return GazeEstimator2.apply(params, x, extract_feature=True, train=train, gen=gen,
                                    compute_dtype=compute_dtype)

    def train_step(params, opt, x, y, gen):
        o = forward(params, x, gen)
        loss = cosine_embedding_loss(o, y)
        opt.zero_grad(set_to_none=True)
        loss.backward()
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


def gaze_estimation(cfg: WorkloadConfig, device: torch.device, lrs=LRS, resnet_weights: str = "") -> dict:
    seed_all(cfg.seed)
    base = os.path.join(cfg.data_dir, "openeds2020", "openEDS2020-GazePrediction")
    if os.path.isdir(base):
        raise SystemExit(f"{base} exists, but streaming the real OpenEDS2020 frames is not ported "
                         "yet (ROADMAP item 13); run without it for the synthetic twin")
    print(f"[data] {base} not found -> synthetic gaze twin")
    if N_TRAIN < cfg.bs:
        raise SystemExit(f"the twin's {N_TRAIN} training frames give no step at -bs {cfg.bs} "
                         "(the last short batch is dropped); use -bs 96 or less")
    resnet_pre = None
    if cfg.estimator == 2 and (resnet_weights or pretrained_path("resnet50")):
        resnet_pre = load_pretrained("resnet50", resnet_weights, None, device)
    compute_dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32

    train = _synthetic_gaze(N_TRAIN, cfg.estimator, seed=cfg.seed, device=device)
    valid = _synthetic_gaze(N_EVAL, cfg.estimator, seed=cfg.seed, device=device)
    splits = [("valid", valid)] + ([("test", _synthetic_gaze(N_EVAL, cfg.estimator, seed=cfg.seed,
                                                             device=device))] if cfg.test else [])
    train_step, eval_step = make_steps(cfg.estimator, compute_dtype)

    final: dict = {}
    for lr in lrs:
        gen = seed_all(cfg.seed)
        kind = "model-based" if cfg.estimator == 1 else "appearance-based"
        logger = MetricLogger(cfg.project, f"seed {cfg.seed} {kind} lr {lr}", {**cfg.to_dict(), "lr": lr})
        if cfg.estimator == 1:
            params = GazeEstimator1.init(gen, device=device)
        else:
            params = GazeEstimator2.init(gen, extract_feature=True, device=device)
            if resnet_pre is not None:  # reference resnet.py:18-21
                params["resnet"] = pytree.tree_map(torch.clone, resnet_pre)  # each lr starts afresh
        opt = torch.optim.Adam(trainable(params), lr=lr)
        timer = StepTimer()
        # seed-scoped, so --resume never restores another configuration's state
        ckpt_dir = f"saved/checkpoints/gaze_estimator{cfg.estimator}_lr_{lr}_seed_{cfg.seed}"
        start_epoch = resume_training_state(ckpt_dir, params, opt) if cfg.resume else 0
        if start_epoch:
            print(f"resumed lr {lr} from epoch {start_epoch}")

        drop_gen = torch.Generator(device=device)
        for e in range(start_epoch, cfg.epochs):
            log: dict = {}
            preds, labels = [], []
            it = batch_iterator(train, cfg.bs, shuffle=True, seed=cfg.seed + e, drop_remainder=True)
            for bi, (x, y) in enumerate(prefetch_to_device(it, device)):
                drop_gen.manual_seed(cfg.seed * 1_000_000_000 + e * 100_000 + bi)
                with timer:
                    _, o = train_step(params, opt, x, y, drop_gen)
                    _sync(device)
                preds.append(o)
                labels.append(y)
            _epoch_metrics(torch.cat(preds), torch.cat(labels), "train", log)

            for split_name, (feats, gaze) in splits:
                preds = [eval_step(params, batch[0])
                         for batch in prefetch_to_device(batch_iterator((feats, gaze), cfg.bs), device)]
                # the padded rows of the last batch come last
                _epoch_metrics(torch.cat(preds)[: len(gaze)], torch.from_numpy(gaze), split_name, log)

            log["train/steps_per_sec"] = timer.per_sec()
            logger.log(log)
            final = log
            if cfg.save_period > 0 and (e + 1) % cfg.save_period == 0:
                save_training_state(ckpt_dir, e + 1, params, opt)
        logger.finish()
    return final


def main(argv: list[str] | None = None):
    parser = argparse.ArgumentParser()
    defaults = WorkloadConfig(project="iris-style-transfer", epochs=150, bs=128, save_period=10)
    add_common_args(parser, defaults)
    parser.add_argument("--resnet_weights", type=str, default="",
                        help="ported ResNet50 IMAGENET1K_V2 npz for GazeEstimator2's backbone")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to run on; a CUDA request without CUDA fails")
    cfg, args = parse_config(parser, defaults, argv)
    if cfg.estimator not in (1, 2):
        raise SystemExit(f"-estimator must be 1 or 2, got {cfg.estimator}")
    device = resolve_device(args.device)
    if cfg.model_parallel > 1:
        raise SystemExit("--model_parallel > 1 needs a multi-device mesh, which the torch "
                         "port does not have yet (ROADMAP: multi-device data parallelism)")
    return gaze_estimation(cfg, device, resnet_weights=args.resnet_weights)


if __name__ == "__main__":
    main()
