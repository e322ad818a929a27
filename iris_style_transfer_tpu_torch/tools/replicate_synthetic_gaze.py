"""Gaze-preservation replication on the synthetic twin (the OpenEDS2020
analog): does masked-iris NST keep gaze estimation working?

Counterpart of the repository's ``tools/replicate_synthetic_gaze.py``, with
its flags and summary keys (plus ``--device``, and ``--estimator1_steps``
and ``--estimator2_epochs`` at the JAX trainers' defaults).  The twin's
gaze is geometric (the iris offset inside the sclera), so the estimators
learn it:

  0. Train the EfficientNet-B7 U-Net on the twin's ground-truth
     segmentations: bf16 activations, eval-mode batchnorm, the height
     padded by 8 + 8 and the logits cropped back, cross entropy, Adam.
  1. Train GazeEstimator1 on the 19-d landmarks of the trained B7's
     segmentations (full batch, dropout on) and GazeEstimator2 end to end
     (a trainable ResNet50 on the frames), through the gaze trainer's step
     (``workloads/gaze_estimation.py:make_steps``).
  2. Run the 2020 IST pipeline (``workloads/ist_openeds2020.py``) on the
     held-out frames with a one-for-all style iris from a training frame.

    python -m iris_style_transfer_tpu_torch.tools.replicate_synthetic_gaze [--out results_gaze]

Run it from a scratch directory: it writes ``saved/``.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch
import torch.nn.functional as F

from ..data import synthetic_eye_batch
from ..models import EfficientNet, GazeEstimator1, GazeEstimator2
from ..ops.ellipse import extract_eye_landmarks
from ..ops.image import gray_to_rgb, imagenet_normalize, pad_height
from ..ops.metrics import angular_distance, iou_per_class
from ..runtime import MetricLogger, trainable
from ..runtime.config import WorkloadConfig, resolve_device
from ..utils import prepare_dir
from ..workloads.gaze_estimation import make_steps
from ..workloads.iris_classification import seeded_vgg19
from ..workloads.ist_openeds2020 import iris_style_transfer_openeds2020, make_style_iris
from .replicate_synthetic import shuffled_steps, stacked, stage_done, write_summary

CHUNK = 8  # frames per B7 apply and per landmark extraction


def _seg_apply_chunked(params: dict, frames: torch.Tensor, chunk: int = CHUNK) -> torch.Tensor:
    """B7 labels (N, H, W) of (N, H, W, 1) frames, in chunks, float32."""
    with torch.no_grad():
        return torch.cat([EfficientNet.apply(params, frames[i : i + chunk]) for i in range(0, len(frames), chunk)])


def b7_train_loss(params: dict, x: torch.Tensor, y: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """Cross entropy of B7's logits on (B, H, W, 1) frames in [0,1] against
    (B, H, W) labels: gray to RGB, the height padded by 8 + 8, ImageNet
    normalization, activations in ``dtype``, the logits back in f32 and
    cropped."""
    h = pad_height(x.repeat_interleave(3, dim=-1), 8, 8).permute(0, 3, 1, 2)
    h = imagenet_normalize(h).to(dtype).contiguous(memory_format=torch.channels_last)
    logits = EfficientNet.logits(params, h).float()[:, :, 8:-8, :]
    return F.cross_entropy(logits, y)


def train_efficientnet(frames, segs, *, epochs: int, bs: int = 2, lr: float = 1e-3, seed: int = 13, device="cpu",
                       init_params: dict | None = None, dtype=torch.bfloat16) -> tuple[dict, torch.Tensor]:
    """Train the B7 U-Net on (frames, segmentations) with
    :func:`b7_train_loss` (activations in ``dtype``) and Adam; batchnorm
    stays in eval mode (its running statistics at init: an affine layer).
    Starts from ``init_params`` when given, else from ``EfficientNet.init``
    seeded with ``seed``.  Returns the params and the per-step losses."""
    xs = torch.as_tensor(np.stack(frames)).to(device)
    ys = torch.from_numpy(np.stack(segs).astype(np.int64)).to(device)
    params = init_params if init_params is not None else EfficientNet.init(torch.Generator().manual_seed(seed), device)
    opt = torch.optim.Adam(trainable(params), lr=lr)
    rng = np.random.default_rng(seed)
    losses = []
    for e in range(epochs):
        for idx in shuffled_steps(rng, len(xs), bs, device):
            loss = b7_train_loss(params, xs[idx], ys[idx], dtype)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            losses.append(loss.detach())
        if losses:
            print(f"  effnet epoch {e + 1}/{epochs} loss {float(losses[-1]):.4f}", flush=True)
    return params, stacked(losses)


def train_estimator1(segs_pred: torch.Tensor, gaze, *, epochs: int = 800, lr: float = 1e-3, seed: int = 21,
                     device="cpu", init_params: dict | None = None) -> tuple[dict, torch.Tensor]:
    """GazeEstimator1 on the landmarks of predicted segmentations: full
    batch, Adam, dropout on (a generator seeded per step).  Returns the
    params and the per-step losses."""
    segs_pred = segs_pred.to(device)
    feats = torch.cat([extract_eye_landmarks(segs_pred[i : i + CHUNK]) for i in range(0, len(segs_pred), CHUNK)])
    y = torch.as_tensor(gaze).to(device)
    params = init_params if init_params is not None else GazeEstimator1.init(
        torch.Generator().manual_seed(seed), device=device)
    opt = torch.optim.Adam(trainable(params), lr=lr)
    train_step, _ = make_steps(1)
    drop_gen = torch.Generator(device=device)
    losses = []
    for i in range(epochs):
        drop_gen.manual_seed((seed + 1) * 1_000_000 + i)
        losses.append(train_step(params, opt, feats, y, drop_gen)[0])
    losses = stacked(losses)
    if len(losses):
        print(f"  estimator1 final loss {float(losses[-1]):.4f}", flush=True)
    return params, losses


def train_estimator2(frames, gaze, *, epochs: int = 6, bs: int = 8, lr: float = 1e-4, seed: int = 22, device="cpu",
                     init_params: dict | None = None) -> tuple[dict, torch.Tensor]:
    """GazeEstimator2 end to end: a trainable ResNet50 on RGB frames in
    float32, Adam, dropout on, the order of ``np.random.default_rng(seed)``
    each epoch with the last short batch dropped.  Returns the params and
    the per-step losses."""
    xs = torch.as_tensor(np.stack(frames)).to(device)
    y = torch.as_tensor(gaze).to(device)
    params = init_params if init_params is not None else GazeEstimator2.init(
        torch.Generator().manual_seed(seed), extract_feature=True, device=device)
    opt = torch.optim.Adam(trainable(params), lr=lr)
    train_step, _ = make_steps(2, torch.float32)
    drop_gen = torch.Generator(device=device)
    rng = np.random.default_rng(seed)
    losses = []
    for e in range(epochs):
        for bi, idx in enumerate(shuffled_steps(rng, len(xs), bs, device)):
            drop_gen.manual_seed((seed + 1) * 1_000_000 + e * 1000 + bi)
            losses.append(train_step(params, opt, gray_to_rgb(xs[idx]), y[idx], drop_gen)[0])
        if losses:
            print(f"  estimator2 epoch {e + 1}/{epochs} loss {float(losses[-1]):.4f}", flush=True)
    return params, stacked(losses)


def parser() -> argparse.ArgumentParser:
    """The tool's flags, at the JAX tool's defaults."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--n_train", type=int, default=160)
    ap.add_argument("--n_eval", type=int, default=32)
    ap.add_argument("--effnet_epochs", type=int, default=6)
    ap.add_argument("--estimator1_steps", type=int, default=800)
    ap.add_argument("--estimator2_epochs", type=int, default=6)
    ap.add_argument("--ist_bs", type=int, default=8)
    ap.add_argument("--nst_epochs", type=int, default=200)
    ap.add_argument("--s_loss_weight", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--out", type=str, default="")
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device to run on; a CUDA request without CUDA fails")
    return ap


def main(argv: list[str] | None = None) -> dict:
    args = parser().parse_args(argv)
    device = resolve_device(args.device)

    t = time.perf_counter()
    n = args.n_train + args.n_eval
    imgs, segs, _, gaze = synthetic_eye_batch(n, seed=args.seed, gaze=True)
    tr, ev = slice(0, args.n_train), slice(args.n_train, n)
    frames = torch.from_numpy(imgs).to(device)
    print(f"synthetic gaze twin: {args.n_train} train / {args.n_eval} eval", flush=True)
    t = stage_done("twin", t)

    # ---- stage 0: B7 U-Net on the twin ----
    eff_params, _ = train_efficientnet(imgs[tr], segs[tr], epochs=args.effnet_epochs, device=device)
    _, miou = iou_per_class(_seg_apply_chunked(eff_params, frames[ev]), torch.from_numpy(segs[ev]).to(device))
    eff_miou = float(np.nanmean(miou.cpu().numpy()))
    print(f"effnet trained on the twin: eval mIoU {eff_miou:.4f}", flush=True)
    t = stage_done("stage 0, B7 U-Net", t)

    # ---- stage 1: gaze estimators ----
    g1_params, _ = train_estimator1(_seg_apply_chunked(eff_params, frames[tr]), gaze[tr],
                                    epochs=args.estimator1_steps, device=device)
    t = stage_done("stage 1, estimator 1 (with B7's segmentations)", t)
    g2_params, _ = train_estimator2(imgs[tr], gaze[tr], epochs=args.estimator2_epochs, device=device)
    t = stage_done("stage 1, estimator 2", t)

    # ---- stage 2: the 2020 privacy pipeline on the held-out split ----
    vgg_params, _ = seeded_vgg19(args.seed, device)
    cfg = WorkloadConfig(project="replicate-synthetic-gaze", bs=args.ist_bs)
    # the one-for-all style iris from a training frame (reference :237-249)
    s_iris = make_style_iris(eff_params, frames[0], cfg.glint_threshold, torch.float32)
    save_dir = "saved/replicate_synthetic_gaze/validation/"
    prepare_dir(save_dir, idempotent=True)
    logger = MetricLogger(cfg.project, f"replicate gaze seed {args.seed}", cfg.to_dict())
    log = iris_style_transfer_openeds2020(
        cfg, imgs[ev], gaze[ev], eff_params, g1_params, g2_params, vgg_params, s_iris, cfg.c_loss_weight,
        args.s_loss_weight, args.nst_epochs, "validation/", save_dir, logger, device,
    )
    logger.finish()
    stage_done("stage 2, IST pipeline", t)

    # chance: the mean angular error of random unit predictions against
    # this gaze distribution
    rnd = np.random.default_rng(0).normal(size=(len(gaze[ev]), 3)).astype(np.float32)
    rnd /= np.linalg.norm(rnd, axis=1, keepdims=True)
    _, chance_deg = angular_distance(torch.from_numpy(rnd), torch.from_numpy(gaze[ev]))

    return write_summary({
        "effnet/eval_miou": eff_miou,
        "pre/degree_distance1": log["validation//pre/degree_distance1"],
        "pre/degree_distance2": log["validation//pre/degree_distance2"],
        "post/degree_distance1": log["validation//post/degree_distance1"],
        "post/degree_distance2": log["validation//post/degree_distance2"],
        "chance_degree_distance": float(chance_deg.mean()),
        "stylized_images_per_min": log["validation//stylized_images_per_min"],
    }, args.out)


if __name__ == "__main__":
    main()
