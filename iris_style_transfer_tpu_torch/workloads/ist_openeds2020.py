"""Iris style transfer privacy evaluation — OpenEDS2020 (gaze preservation),
data-parallel.

Counterpart of ``iris_style_transfer_tpu/workloads/ist_openeds2020.py``
(reference ``iris_style_transfer_openeds2020.py``): one fixed style iris for
all content frames (a frame masked by the B7 U-Net and cropped).  Per
batch: segment the frames with the B7 U-Net (flip TTA), estimate gaze with
both estimators (landmarks from the segmentation; ResNet50 features) and
score the angular distance to the labels; extract and crop the irises; run
the joint NST over the (B, 3, 224, 224) iris batch; composite the stylized
irises back; segment and estimate again.  Epoch-end aggregation saves the
predictions and labels and logs the mean distances.  Flags and metric
names are the JAX workload's (``validation//post/degree_distance1``, with
its double slash), plus ``--device``.

Its sweep's loop, metric worker, spans and mesh are
``workloads/sweep.py``'s.  The full-resolution programs (B7 + both
estimators at 400x640) run in chunks of :data:`SEG_CHUNK` frames under
``torch.no_grad()``, on a mesh on the rank's block, and the predictions
are gathered; ``ist.stage`` (the pre program's quantize and host-to-card
copy) is its own span, inside ``ist.pre``.  With
``--data_dir/openeds2020/openEDS2020-GazePrediction`` present the run reads
that OpenEDS2020 tree: each split's labels eagerly, its frames streamed in
order per sweep combination (``data/openeds2020.py:stream_openeds2020``),
and the style iris from the frame ``test/sequences/2577/023.png``, as the
JAX main does.  Without it, the synthetic twin with geometric gaze labels.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..data import batch_iterator, load_labels_openeds2020, stream_openeds2020, synthetic_eye_batch
from ..models import EfficientNet, GazeEstimator1, GazeEstimator2, VGG19, load_pretrained, pretrained_path
from ..ops.image import crop_and_resize, gray_to_rgb, nonzero_bbox, quantize_u8, to_unit_float
from ..ops.metrics import angular_distance
from ..parallel.mesh import Mesh, gather_batch, height_sharding, one_rank, replicated, shard_batch
from ..pipelines import composite_batch, extract_iris_batch
from ..runtime import MetricLogger, WorkloadConfig, restore_params
from ..runtime.profiler import span
from ..transfer.nst import cached_nst_program
from ..utils import read_image_gray, seed as seed_all
from .sweep import CROP, Sweep, run_combos, sweep_main

# frames per B7 + ResNet50 chunk at 400x640.  At 32 one bf16 B7 chunk
# apply peaks at 5.06 GB and the whole main at 13.16 GB on an NVIDIA H100
# 80GB HBM3 at 700 W (PERF.md §4); the batch of 128 takes 4 chunks, each
# launching the depthwise kernel 102 times.
SEG_CHUNK = 32


def make_programs(glint_threshold: float, compute_dtype, device, mesh: Mesh | None = None):
    """The combo-independent per-batch programs, in chunks of SEG_CHUNK frames:
    pre (segment, both estimators, iris extraction) and post (composite,
    re-segment, both estimators).  Built once per process.  With ``mesh``,
    pre takes the global batch of host frames and stages this rank's
    block; every output is the block's."""

    def _estimate(eff_params, g1_params, g2_params, frames):
        segs = EfficientNet.apply(eff_params, frames, compute_dtype=compute_dtype)
        p1 = GazeEstimator1.apply(g1_params, segs, extract_feature=True)
        p2 = GazeEstimator2.apply(g2_params, gray_to_rgb(frames), extract_feature=True,
                                  compute_dtype=compute_dtype)
        return segs, p1, p2

    @torch.no_grad()
    def pre_fn(eff_params, g1_params, g2_params, c_imgs):
        """c_imgs: host frames (B, H, W, 1).  They go to the device as
        uint8, and the staged frames come back as the last output, so the
        post program composites into them without a second copy."""
        with span("ist.stage"):
            if mesh is not None:
                c_imgs = shard_batch(mesh, np.asarray(c_imgs))
            staged = torch.from_numpy(quantize_u8(np.asarray(c_imgs))).to(device)
        outs = []
        for i in range(0, staged.shape[0], SEG_CHUNK):
            frames = to_unit_float(staged[i : i + SEG_CHUNK])
            segs, p1, p2 = _estimate(eff_params, g1_params, g2_params, frames)
            irises, masks, bboxes = extract_iris_batch(frames, segs, glint_threshold)
            outs.append((p1, p2, irises, masks, bboxes))
        return tuple(torch.cat(parts) for parts in zip(*outs)) + (staged,)

    @torch.no_grad()
    def post_fn(eff_params, g1_params, g2_params, frames_u8, stylized, masks, bboxes):
        """``stylized`` is the NST output, (B, 3, 224, 224)."""
        outs = []
        for i in range(0, frames_u8.shape[0], SEG_CHUNK):
            sl = slice(i, i + SEG_CHUNK)
            new_frames = composite_batch(to_unit_float(frames_u8[sl]), stylized[sl].permute(0, 2, 3, 1),
                                         masks[sl], bboxes[sl])
            _, p1, p2 = _estimate(eff_params, g1_params, g2_params, new_frames)
            outs.append((new_frames, p1, p2))
        return tuple(torch.cat(parts) for parts in zip(*outs))

    return pre_fn, post_fn


def _gaze_metric_job(metric_prefix, phase, p1, p2, labs_v, valid):
    """Per-batch angular distances of one phase (pre/post), on the metric
    worker; the device->host copies of the predictions happen here."""
    p1v, p2v = p1.cpu().numpy()[valid], p2.cpu().numpy()[valid]
    out = {}
    for i, pv in (("1", p1v), ("2", p2v)):
        rad = np.arccos(np.clip(np.sum(pv * labs_v, axis=1), -1.0, 1.0))
        out[f"{metric_prefix}/batch/{phase}/radian_distance{i}"] = float(rad.mean())
        out[f"{metric_prefix}/batch/{phase}/degree_distance{i}"] = float(np.degrees(rad).mean())
    return out, {f"{phase}1": p1v, f"{phase}2": p2v}


def iris_style_transfer_openeds2020(
    cfg: WorkloadConfig,
    images,
    labels: np.ndarray,
    eff_params,
    g1_params,
    g2_params,
    vgg_params,
    s_iris: torch.Tensor,
    c_loss_weight: float,
    s_loss_weight: float,
    nst_epoch: int,
    metric_prefix: str,
    save_dir: str,
    logger: MetricLogger,
    device: torch.device,
    save_period: int = 50,
    programs=None,
    mesh: Mesh | None = None,
) -> dict:
    """One sweep combo over ``images`` (N, H, W, 1) with unit gaze
    ``labels`` (N, 3), or over the batches of ``images()``, a zero-argument
    factory of a (frames, labels, valid) stream such as
    :func:`stream_openeds2020`'s; ``s_iris`` is the (224, 224, 1) style
    iris.  With ``mesh`` (None: ``device`` alone) each rank runs its block
    of every batch (``programs`` built with the same mesh), and rank 0
    writes."""
    mesh = mesh if mesh is not None else one_rank(device)
    compute_dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
    if programs is None:
        programs = make_programs(cfg.glint_threshold, compute_dtype, device, mesh)
    pre_fn, post_fn = programs
    nst_fn = cached_nst_program(
        nst_epoch, float(c_loss_weight), float(s_loss_weight), cfg.compute_dtype, cfg.history_size,
        cfg.stats_taps, mesh,
    )
    s_iris_rgb = gray_to_rgb(s_iris.to(device)).permute(2, 0, 1)  # (3, 224, 224)
    sweep = Sweep(mesh, device, metric_prefix, save_dir, save_period, c_loss_weight, s_loss_weight)

    def unpack(batch):
        return batch[0], batch[1], batch[2] if len(batch) > 2 else np.ones(len(batch[1]), bool)

    def body(c_imgs, labs, valid):
        sweep.save(raw=c_imgs)
        with span("ist.pre"):  # the program, and its metrics handed to the worker
            p1, p2, irises, masks, bboxes, frames_dev = pre_fn(eff_params, g1_params, g2_params, c_imgs)
            # metrics over valid rows only: padded rows repeat the last frame
            labs_v = np.asarray(labs)[valid]
            sweep.submit(_gaze_metric_job, metric_prefix, "pre", gather_batch(mesh, p1), gather_batch(mesh, p2),
                         labs_v, valid)
            sweep.agg["labels"].append(labs_v)
            rows = height_sharding(mesh, CROP[0])  # this rank's slab of the irises' H
        with sweep.nst(lambda: nst_fn(vgg_params, irises.permute(0, 3, 1, 2)[:, :, rows],
                                      s_iris_rgb[:, rows].expand(irises.shape[0], -1, -1, -1))) as stylized:
            new_frames, p1, p2 = post_fn(eff_params, g1_params, g2_params, frames_dev, stylized, masks, bboxes)
            sweep.submit(_gaze_metric_job, metric_prefix, "post", gather_batch(mesh, p1), gather_batch(mesh, p2),
                         labs_v, valid)
        sweep.save(new=new_frames)

    batches = images() if callable(images) else batch_iterator((images, labels), cfg.bs, pad_final=True)
    agg = sweep.run(batches, unpack, body, logger)

    with span("ist.aggregate"):
        log = {}
        labels_all = np.concatenate(agg["labels"])
        if mesh.is_main:
            np.save(f"{save_dir}labels.npy", labels_all)
        for phase in ("pre", "post"):
            for i in ("1", "2"):
                preds = np.concatenate(agg[f"{phase}{i}"])
                if mesh.is_main:
                    np.save(f"{save_dir}preds{i}_{phase}.npy", preds)
                rad, deg = angular_distance(torch.from_numpy(preds), torch.from_numpy(labels_all))
                log[f"{metric_prefix}/{phase}/radian_distance{i}"] = float(rad.mean())
                log[f"{metric_prefix}/{phase}/degree_distance{i}"] = float(deg.mean())
        log.update(sweep.loss_means())
        log.update({f"{metric_prefix}/{k}": v for k, v in sweep.rates(cfg.bs).items() if k != "nst_batches_per_sec"})
        logger.log(log)
    return log


def make_style_iris(eff_params, img: torch.Tensor, glint_threshold: float, compute_dtype) -> torch.Tensor:
    """The one-for-all style iris: segment one (H, W, 1) frame, mask its
    iris below the glint threshold, crop to the mask's extent and resize
    to (224, 224, 1)."""
    with torch.no_grad():
        seg = EfficientNet.apply(eff_params, img[None], compute_dtype=compute_dtype)[0]
        m = (seg == 2)[..., None] & (img <= glint_threshold)
        masked = img * m.to(img.dtype)
        bb = nonzero_bbox(masked[None, ..., 0])
        return crop_and_resize(masked[None], bb, (224, 224))[0]


def main(argv: list[str] | None = None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-path1", "--estimator1_path", type=str, default="")
    parser.add_argument("-path2", "--estimator2_path", type=str, default="")
    parser.add_argument("--effnet_weights", type=str, default="",
                        help="ported smp Unet(efficientnet-b7) npz in the JAX package's format")
    parser.add_argument("--resnet_weights", type=str, default="",
                        help="ported ResNet50 IMAGENET1K_V2 npz for GazeEstimator2's backbone")
    return sweep_main(main, argv, parser, WorkloadConfig(project="iris-style-transfer-openeds2020", bs=128), _sweeps)


def _sweeps(cfg: WorkloadConfig, args, mesh: Mesh) -> dict:
    """Every combo of the validation split, and the train and test splits with ``--eval_train``, ``--eval_test``."""
    device = mesh.device
    gen = seed_all(cfg.seed)
    vgg_params = load_pretrained("vgg19", args.vgg_weights, lambda: VGG19.init(gen, device), device)
    eff_params = load_pretrained("efficientnet_unet", args.effnet_weights,
                                 lambda: EfficientNet.init(gen, device), device)
    # estimators: an exact checkpoint file, the latest step of a directory,
    # or the seeded init
    g1_params = restore_params(args.estimator1_path, GazeEstimator1.init(gen, device=device), device)
    g2_params = restore_params(args.estimator2_path, None, device)
    if g2_params is None:
        g2_params = GazeEstimator2.init(gen, extract_feature=True, device=device)
        # no trained estimator: at least the pretrained backbone, when ported
        if args.resnet_weights or pretrained_path("resnet50"):
            g2_params["resnet"] = load_pretrained("resnet50", args.resnet_weights, None, device)
    vgg_params, eff_params, g1_params, g2_params = (
        replicated(mesh, p) for p in (vgg_params, eff_params, g1_params, g2_params))

    base = os.path.join(cfg.data_dir, "openeds2020", "openEDS2020-GazePrediction")
    use_real = os.path.isdir(base)
    if use_real:  # the reference's hand-picked style frame (:237-249)
        s_img = read_image_gray(os.path.join(base, "test", "sequences", "2577", "023.png"))
        s_img = s_img.astype(np.float32)[..., None] / 255.0
    else:
        print(f"[data] {base} not found -> synthetic dataset")
        s_img = synthetic_eye_batch(1, seed=cfg.seed + 999)[0][0]
    compute_dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
    s_img = torch.from_numpy(s_img).to(device)
    s_iris = make_style_iris(eff_params, s_img, cfg.glint_threshold, compute_dtype)

    postfixes = ["validation/"]
    if cfg.eval_train:
        postfixes.append("train/")
    if cfg.eval_test:
        postfixes.append("test/")
    results = {}
    programs = make_programs(cfg.glint_threshold, compute_dtype, device, mesh)

    for postfix in postfixes:
        print(f"loading {postfix[:-1]} set...")
        if use_real:
            # labels eagerly (small files); frames streamed anew for each
            # sweep combination: a split holds up to 550K frames
            labels = load_labels_openeds2020(base + "/", postfix)
            images = lambda p=postfix: stream_openeds2020(base + "/", p, cfg.bs)
        else:
            # the twin's gaze is geometric (the iris offset inside the sclera)
            images, _, _, labels = synthetic_eye_batch(24, seed=cfg.seed, gaze=True)
        print(f"number of samples in {postfix} set:", len(labels))

        def run(sw, nst_epoch, save_dir, logger):
            if mesh.is_main:
                np.save(f"{save_dir}gts.npy", labels)
            return iris_style_transfer_openeds2020(
                cfg, images, labels, eff_params, g1_params, g2_params, vgg_params, s_iris,
                cfg.c_loss_weight, sw, nst_epoch, postfix, save_dir, logger, device,
                programs=programs, mesh=mesh,
            )

        results |= run_combos(cfg, args, mesh, "openeds2020", postfix, "test", run,
                              vgg_weights=args.vgg_weights, effnet_weights=args.effnet_weights,
                              resnet_weights=args.resnet_weights, estimator1_path=args.estimator1_path,
                              estimator2_path=args.estimator2_path)
    return results


if __name__ == "__main__":
    main()
