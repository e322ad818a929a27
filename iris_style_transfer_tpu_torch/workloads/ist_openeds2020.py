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

The full-resolution programs (B7 + both estimators at 400x640) run in
chunks of :data:`SEG_CHUNK` frames under ``torch.no_grad()``.  Host metric
work runs on one worker thread, overlapped with the next batch's device
work, and is drained in batch order.  With
``--data_dir/openeds2020/openEDS2020-GazePrediction`` present the run reads
that OpenEDS2020 tree: each split's labels eagerly, its frames streamed in
order per sweep combination (``data/openeds2020.py:stream_openeds2020``),
and the style iris from the frame ``test/sequences/2577/023.png``, as the
JAX main does.  Without it, the synthetic twin with geometric gaze labels.

On a mesh (``--n_devices N``, or ``torchrun``; ``parallel/mesh.py``) every
rank walks the same global batches and runs B7, both estimators, the joint
NST (its L-BFGS reduced over the data group) and the composite on its
block, in chunks of :data:`SEG_CHUNK` frames; the predictions are
gathered, and rank 0 alone writes logs, PNGs, arrays and ``done.json``.
``--model_parallel m`` (JAX's spatial sharding) makes the mesh (n/m data,
m model): B7, both estimators and the composite run on the rank's data
block, repeated over its model group; the NST runs on the rank's slab of
H rows of that block (its L-BFGS reduced over every rank), and one gather
over the model group restores the whole stylized irises.  ``(224 / 8) %
m`` must be 0, as in JAX.

Each sweep is a run of ``runtime/profiler.py``'s spans, as in the 2019
main, with ``ist.stage`` (the pre program's quantize and host-to-card
copy) inside ``ist.pre`` and no ``ist.seg``.
"""

from __future__ import annotations

import argparse
import itertools
import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..data import batch_iterator, load_labels_openeds2020, stream_openeds2020, synthetic_eye_batch
from ..models import EfficientNet, GazeEstimator1, GazeEstimator2, VGG19, load_pretrained, pretrained_path
from ..ops.image import crop_and_resize, gray_to_rgb, nonzero_bbox, quantize_u8, to_unit_float
from ..ops.metrics import angular_distance
from ..parallel.mesh import (
    Mesh,
    barrier,
    gather_batch,
    gather_height,
    height_sharding,
    one_rank,
    replicated,
    shard_batch,
)
from ..pipelines import composite_batch, extract_iris_batch
from ..runtime import MetricLogger, StepTimer, restore_params
from ..runtime.config import (
    WorkloadConfig,
    add_common_args,
    check_model_parallel,
    main_mesh,
    parse_config,
    resolve_device,
    run_on_ranks,
    spawns_ranks,
)
from ..runtime.profiler import at_batch, job, new_run, span
from ..transfer.nst import cached_nst_program
from ..utils import prepare_dir, read_image_gray, save_png, seed as seed_all, sweep_done, write_sweep_marker
from .ist_openeds2019 import CROP, _sync

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


def _loss_job(metric_prefix, c_hist, s_hist, c_w, s_w):
    c_loss, s_loss = float(c_hist[-1].item()), float(s_hist[-1].item())
    log = {
        f"{metric_prefix}/batch/c_loss": c_loss,
        f"{metric_prefix}/batch/s_loss": s_loss,
        f"{metric_prefix}/batch/cs_loss": c_loss * c_w + s_loss * s_w,
    }
    return log, {"c_loss": c_loss, "s_loss": s_loss}


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

    agg = {"pre1": [], "pre2": [], "post1": [], "post2": [], "labels": [], "c_loss": [], "s_loss": []}
    timer = StepTimer()
    metric_pool = ThreadPoolExecutor(max_workers=1)
    pending: list[tuple[dict, list]] = []
    pipe_times: list[float] = []

    new_run()
    batches = iter(images() if callable(images) else batch_iterator((images, labels), cfg.bs, pad_final=True))
    try:
        for batch_id in itertools.count():
            at_batch(batch_id)
            with span("ist.load"):
                batch = next(batches, None)
                t_batch = time.perf_counter()
                if batch is not None:
                    c_imgs, labs = batch[0], batch[1]
                    valid = batch[2] if len(batch) > 2 else np.ones(len(labs), bool)
            if batch is None:
                break
            if batch_id % save_period == 0 and mesh.is_main:
                with span("ist.save"):
                    save_png(f"{save_dir}batch_{batch_id}_raw.png", c_imgs[0])

            with span("ist.pre"):  # the program, and its metrics handed to the worker
                p1, p2, irises, masks, bboxes, frames_dev = pre_fn(eff_params, g1_params, g2_params, c_imgs)
                # metrics over valid rows only: padded rows repeat the last frame
                labs_v = np.asarray(labs)[valid]
                futs = [metric_pool.submit(job("ist.metric_job", _gaze_metric_job), metric_prefix, "pre",
                                           gather_batch(mesh, p1), gather_batch(mesh, p2), labs_v, valid)]
                agg["labels"].append(labs_v)
                rows = height_sharding(mesh, CROP[0])  # this rank's slab of the irises' H

            with timer:
                with span("ist.nst"):
                    s_batch = s_iris_rgb[:, rows].expand(irises.shape[0], -1, -1, -1)
                    result = nst_fn(vgg_params, irises.permute(0, 3, 1, 2)[:, :, rows], s_batch)
                    stylized = gather_height(mesh, result.x)
                with span("ist.nst_sync"):
                    _sync(device)

            with span("ist.post"):  # the NST's losses to the worker, the program, its metrics to the worker
                futs.append(metric_pool.submit(
                    job("ist.metric_job", _loss_job), metric_prefix, result.c_loss_hist, result.s_loss_hist,
                    c_loss_weight, s_loss_weight,
                ))
                new_frames, p1, p2 = post_fn(eff_params, g1_params, g2_params, frames_dev, stylized, masks, bboxes)
                futs.append(metric_pool.submit(job("ist.metric_job", _gaze_metric_job), metric_prefix, "post",
                                               gather_batch(mesh, p1), gather_batch(mesh, p2), labs_v, valid))

            if batch_id % save_period == 0 and mesh.is_main:  # rank 0's block starts the batch
                with span("ist.save"):
                    save_png(f"{save_dir}batch_{batch_id}_new.png", new_frames[0].cpu().numpy())
            pending.append(({}, futs))
            pipe_times.append(time.perf_counter() - t_batch)

        # drain in batch order; the drain's wall time counts against the
        # end-to-end throughput below
        at_batch(None)
        with span("ist.drain"):
            t_drain0 = time.perf_counter()
            for blog, futs in pending:
                for f in futs:
                    log_upd, agg_upd = f.result()
                    blog.update(log_upd)
                    for k, v in agg_upd.items():
                        agg[k].append(v)
                logger.log(blog)
            t_drain = time.perf_counter() - t_drain0
    finally:
        metric_pool.shutdown(wait=True)

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
        c_loss = float(np.nanmean(agg["c_loss"]))
        s_loss = float(np.nanmean(agg["s_loss"]))
        log[f"{metric_prefix}/c_loss"] = c_loss
        log[f"{metric_prefix}/s_loss"] = s_loss
        log[f"{metric_prefix}/cs_loss"] = c_loss * c_loss_weight + s_loss * s_loss_weight
        log[f"{metric_prefix}/stylized_images_per_min"] = timer.per_sec(cfg.bs) * 60
        # end to end: the first (warm-up) batch is excluded when there are more
        pipe = pipe_times[1:] if len(pipe_times) > 1 else pipe_times
        if pipe:
            log[f"{metric_prefix}/pipeline_images_per_min"] = cfg.bs * len(pipe) / (sum(pipe) + t_drain) * 60
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
    defaults = WorkloadConfig(project="iris-style-transfer-openeds2020", bs=128)
    add_common_args(parser, defaults)
    parser.add_argument("-path1", "--estimator1_path", type=str, default="")
    parser.add_argument("-path2", "--estimator2_path", type=str, default="")
    parser.add_argument("--vgg_weights", type=str, default="",
                        help="ported VGG19 IMAGENET1K_V1 npz in the JAX package's format")
    parser.add_argument("--effnet_weights", type=str, default="",
                        help="ported smp Unet(efficientnet-b7) npz in the JAX package's format")
    parser.add_argument("--resnet_weights", type=str, default="",
                        help="ported ResNet50 IMAGENET1K_V2 npz for GazeEstimator2's backbone")
    parser.add_argument("--nst_epochs", type=int, nargs="+", default=[200])
    parser.add_argument("--s_loss_weights", type=float, nargs="+", default=[1.0])
    parser.add_argument("--rerun", action="store_true",
                        help="re-run sweep combos that already have a done.json marker")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to run on; a CUDA request without CUDA fails")
    cfg, args = parse_config(parser, defaults, argv)

    device = resolve_device(args.device)
    check_model_parallel(cfg.model_parallel, CROP[0])
    if spawns_ranks(cfg, device):
        return run_on_ranks(main, argv, cfg, device)
    mesh = main_mesh(cfg, device)
    device = mesh.device
    if cfg.bs % mesh.batch_shards:
        raise SystemExit(f"batch size {cfg.bs} not divisible by {mesh.batch_shards} data shards")
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

    presentation = {"name", "project", "num_workers", "resume", "save_period"}
    sweep_config = {k: v for k, v in cfg.to_dict().items() if k not in presentation}
    sweep_config.update(vgg_weights=args.vgg_weights, effnet_weights=args.effnet_weights,
                        resnet_weights=args.resnet_weights, estimator1_path=args.estimator1_path,
                        estimator2_path=args.estimator2_path)

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
        for sw in args.s_loss_weights:
            for nst_epoch in args.nst_epochs:
                save_dir = f"saved/openeds2020/sw_{sw}_epoch_{nst_epoch}/{postfix}"
                done_marker = os.path.join(save_dir, "done.json")
                barrier(mesh)  # rank 0's markers are written before any rank reads them
                if sweep_done(done_marker, sweep_config, defaults=WorkloadConfig().to_dict()) and not args.rerun:
                    print(f"[sweep] {save_dir} already complete, skipping")
                    continue
                if mesh.is_main:
                    prepare_dir(save_dir, idempotent=True)
                    np.save(f"{save_dir}gts.npy", labels)
                name = f"seed {cfg.seed} sw {sw} epoch {nst_epoch} test"
                logger = MetricLogger(cfg.project, name, cfg.to_dict(), enabled=mesh.is_main)
                log = iris_style_transfer_openeds2020(
                    cfg, images, labels, eff_params, g1_params, g2_params, vgg_params, s_iris,
                    cfg.c_loss_weight, sw, nst_epoch, postfix, save_dir, logger, device,
                    programs=programs, mesh=mesh,
                )
                logger.finish()
                if mesh.is_main:
                    write_sweep_marker(done_marker, sweep_config, log)
                results[(postfix, sw, nst_epoch)] = log
    return results


if __name__ == "__main__":
    main()
