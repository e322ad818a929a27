"""Recognition and privacy replication on the synthetic OpenEDS2019 twin.

Counterpart of the repository's ``tools/replicate_synthetic.py``, whose
protocol, flags and summary keys it keeps (plus ``--device``):

  0. Train RITnet from scratch on the twin's ground-truth segmentations
     (the reference's bundled RITnet was trained on OpenEDS2019, so the
     twin's analog is a RITnet trained on the twin).
  1. Train Classifier1 and Classifier2 through the classifier trainer
     (``workloads/iris_classification.py``), on the same twin and over the
     stage-0 RITnet, both passed in as arguments.
  2. Run the 2019 IST pipeline (``workloads/ist_openeds2019.py``) on the
     held-out split with the stage-1 checkpoint's heads and the VGG19 the
     heads were trained against (``seeded_vgg19``).

    python -m iris_style_transfer_tpu_torch.tools.replicate_synthetic \\
        [--epochs 200 --users 8 --n_per_user 24 --bs 16 --lr 1e-4 \\
         --nst_epochs 200 --out results]

Run it from a scratch directory: it writes ``saved/``.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch
import torch.nn.functional as F

from ..data import build_ist_dataset, synthetic_openeds2019
from ..models import RITnet
from ..ops.metrics import iou_per_class
from ..runtime import MetricLogger, restore_params, trainable
from ..runtime.config import WorkloadConfig, resolve_device
from ..utils import prepare_dir
from ..workloads.iris_classification import CKPT_DIR, iris_classification, seeded_vgg19
from ..workloads.ist_openeds2019 import iris_style_transfer_openeds2019

CHUNK = 8  # frames per RITnet transform / apply call


def write_summary(summary: dict, out: str) -> dict:
    """Every value as a float, printed as JSON and, with ``out``, written
    to ``<out>.json``."""
    summary = {k: float(v) for k, v in summary.items()}
    print(json.dumps(summary, indent=2))
    if out:
        with open(out + ".json", "w") as fh:
            json.dump(summary, fh, indent=2)
    return summary


def stage_done(what: str, t0: float) -> float:
    """Print a stage's wall time since ``t0`` (each stage ends on a host
    read of its results); returns the time now."""
    t = time.perf_counter()
    print(f"[time] {what}: {t - t0:.1f} s", flush=True)
    return t


def shuffled_steps(rng: np.random.Generator, n: int, bs: int, device) -> list[torch.Tensor]:
    """One epoch's batch indices, as the JAX tools take them: a permutation
    from ``rng``, the last short batch dropped."""
    order = torch.from_numpy(rng.permutation(n)).to(device)
    return [order[i : i + bs] for i in range(0, n - bs + 1, bs)]


def stacked(losses: list[torch.Tensor]) -> torch.Tensor:
    """Per-step losses kept on the device, fetched once."""
    return torch.stack(losses).cpu() if losses else torch.zeros(0)


def train_ritnet(train_x, train_m, *, epochs: int, bs: int = 4, lr: float = 1e-3, seed: int = 7,
                 device="cpu", init_params: dict | None = None) -> tuple[dict, float, torch.Tensor]:
    """Train RITnet on (frames, segmentations): cross entropy, Adam, the
    order of ``np.random.default_rng(seed)``'s permutation each epoch with
    the last short batch dropped.  uint8 frames are dequantized before the
    [0,1] gamma/CLAHE transform, which runs once over the inputs.  Starts
    from ``init_params`` when given, else from ``RITnet.init`` seeded with
    ``seed``.  Returns the params, the train mIoU and the per-step losses."""
    xs = np.stack(train_x)
    if xs.dtype == np.uint8:
        xs = xs.astype(np.float32) / 255.0
    xs = torch.from_numpy(xs).to(device)
    ys = torch.from_numpy(np.stack(train_m).astype(np.int64)).to(device)
    n = len(xs)
    with torch.no_grad():  # inputs only: no gradient flows through the transform
        xs_t = torch.cat([RITnet.transform(xs[i : i + CHUNK]) for i in range(0, n, CHUNK)])

    params = init_params if init_params is not None else RITnet.init(torch.Generator().manual_seed(seed), device)
    opt = torch.optim.Adam(trainable(params), lr=lr)
    rng = np.random.default_rng(seed)
    losses = []
    for e in range(epochs):
        for idx in shuffled_steps(rng, n, bs, device):
            loss = F.cross_entropy(RITnet.forward(params, xs_t[idx]), ys[idx])
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            losses.append(loss.detach())
        if (e + 1) % 5 == 0 and losses:
            print(f"  ritnet epoch {e + 1}/{epochs} loss {float(losses[-1]):.4f}", flush=True)

    with torch.no_grad():
        seg = torch.cat([RITnet.apply(params, xs[i : i + CHUNK]) for i in range(0, n, CHUNK)])
    _, miou = iou_per_class(seg, ys)
    return params, float(np.nanmean(miou.cpu().numpy())), stacked(losses)


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ritnet_epochs", type=int, default=30)
    ap.add_argument("--epochs", type=int, default=200)
    ap.add_argument("--users", type=int, default=8)
    ap.add_argument("--n_per_user", type=int, default=24)
    ap.add_argument("--bs", type=int, default=16)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--ist_bs", type=int, default=8)
    ap.add_argument("--nst_epochs", type=int, default=200)
    ap.add_argument("--s_loss_weight", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--out", type=str, default="")
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device to run on; a CUDA request without CUDA fails")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    t = time.perf_counter()
    data = synthetic_openeds2019(n_per_user=args.n_per_user, num_users=args.users, seed=args.seed)
    train_x, _, train_m, test_x, test_y, test_m, num_class = data
    print(f"synthetic twin: {len(train_x)} train / {len(test_x)} test, {num_class} users", flush=True)
    t = stage_done("twin", t)

    # ---- stage 0: RITnet on the twin ----
    ritnet_params, ritnet_miou, _ = train_ritnet(train_x, train_m, epochs=args.ritnet_epochs, device=device)
    print(f"ritnet trained on the twin: train mIoU {ritnet_miou:.4f}", flush=True)
    t = stage_done("stage 0, RITnet", t)

    # ---- stage 1: the classifier trainer, on the same twin and RITnet ----
    cfg = WorkloadConfig(project="replicate-synthetic", epochs=args.epochs, bs=args.bs, lr=args.lr,
                         seed=args.seed, save_period=args.epochs)
    cls_metrics = iris_classification(cfg, device, data=data, ritnet_params=ritnet_params, ckpt_dir=CKPT_DIR)
    print("classifier training:", {k: round(v, 4) for k, v in cls_metrics.items() if "/accu" in k}, flush=True)
    t = stage_done("stage 1, classifiers", t)

    # ---- stage 2: the IST privacy pipeline on the held-out split ----
    # the trainer's VGG19; seed_all also seeds the donor draws below
    vgg_params, _ = seeded_vgg19(args.seed, device)
    heads = restore_params(CKPT_DIR, None, device)
    dataset = build_ist_dataset(test_x, test_y, test_m, ritnet_params, cfg.glint_threshold, device=device)
    save_dir = "saved/replicate_synthetic/test/"
    prepare_dir(save_dir, idempotent=True)
    cfg.bs = args.ist_bs
    logger = MetricLogger(cfg.project, f"replicate seed {args.seed}", cfg.to_dict())
    log = iris_style_transfer_openeds2019(
        cfg, dataset, vgg_params, ritnet_params, heads["c1"], heads["c2"], cfg.c_loss_weight,
        args.s_loss_weight, args.nst_epochs, "test/", save_dir, logger, device, num_class=num_class,
    )
    logger.finish()
    stage_done("stage 2, IST pipeline", t)

    return write_summary({
        "ritnet/train_miou": ritnet_miou,
        "train/c1/accu": cls_metrics["train/c1/accu"],
        "train/c2/accu": cls_metrics["train/c2/accu"],
        "test/c1/accu": cls_metrics["test/c1/accu"],
        "test/c2/accu": cls_metrics["test/c2/accu"],
        "ist/pre/c1/accu": log["test/pre/c1/accu"],
        "ist/pre/c2/accu": log["test/pre/c2/accu"],
        "ist/post/c1/accu": log["test/post/c1/accu"],
        "ist/post/c2/accu": log["test/post/c2/accu"],
        "ist/post/c1/mis/accu": log["test/post/c1/mis/accu"],
        "ist/post/c2/mis/accu": log["test/post/c2/mis/accu"],
        "ist/pre/mean_miou": float(np.nanmean(dataset.mious)),
        "ist/post/mean_miou": log["test/post/mean_miou"],
        "chance": 1.0 / num_class,
        "stylized_images_per_min": log["test/stylized_images_per_min"],
    }, args.out)


if __name__ == "__main__":
    main()
