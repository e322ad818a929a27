"""Iris style transfer privacy evaluation — OpenEDS2019 (recognition +
segmentation), data-parallel.

Counterpart of ``iris_style_transfer_tpu/workloads/ist_openeds2019.py``
(reference ``iris_style_transfer_openeds2019.py``).  Per batch: crop the
iris and classify it with both heads, against the true labels and against
the style donors' labels ("mis", false acceptance); run the joint NST over
the (B, 3, 224, 224) iris batch; composite the stylized irises back into
the frames; classify again; re-segment with RITnet and score the IoU.
Epoch-end aggregation writes the IoU arrays and the mean metrics.  Flags
and metric namespaces are the JAX workload's, plus ``--device``.

Host metric work (sklearn-equivalent metrics on the logits, the loss and
IoU read-backs) runs on one worker thread, overlapped with the next
batch's device work.  With ``--data_dir/openeds2019`` present the run
reads that OpenEDS2019 tree, with its segmentation labels
(``data/openeds2019.py:load_data_openeds2019``); without it, the synthetic
twin.

On a mesh (``--n_devices N``, or ``torchrun``; ``parallel/mesh.py``) every
rank walks the same global batches and runs RITnet, the classifiers, the
joint NST (its L-BFGS reduced over the data group) and the composite on
its block; the logits and IoUs are gathered, so the per-batch and epoch
metrics are the global batch's, and rank 0 alone writes logs, PNGs,
arrays and ``done.json``.  ``--model_parallel m`` (JAX's spatial
sharding) makes the mesh (n/m data, m model): RITnet, the classifiers and
the composite run on the rank's data block, repeated over its model group;
the NST runs on the rank's slab of H rows of that block (its L-BFGS
reduced over every rank), and one gather over the model group restores
the whole stylized irises.  ``(224 / 8) % m`` must be 0, as in JAX.

Each sweep is a run of ``runtime/profiler.py``'s spans, which cost one
check each while no profiler records: ``ist.load``, ``ist.pre``,
``ist.nst``, ``ist.nst_sync``, ``ist.post``, ``ist.seg``, ``ist.save``
and ``ist.metric_job`` a batch, then ``ist.drain`` and ``ist.aggregate``.
"""

from __future__ import annotations

import argparse
import itertools
import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..data import batch_iterator, build_ist_dataset, load_data_openeds2019, synthetic_openeds2019
from ..models import Classifier1, Classifier2, RITnet, VGG19, load_pretrained
from ..ops.image import as_bool_mask, as_label_map, crop_and_resize, gray_to_rgb, to_unit_float
from ..ops.metrics import classification_metrics, iou_per_class
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
from ..pipelines import composite_batch
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
from ..utils import prepare_dir, save_png, seed as seed_all, sweep_done, write_sweep_marker

CROP = (224, 224)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def make_programs(compute_dtype, seg_chunk: int = 32):
    """The combo-independent per-batch programs: pre-NST crop + classify,
    post-NST composite + re-crop + classify, chunked re-segmentation."""

    @torch.no_grad()
    def pre_fn(vgg_params, c1, c2, c_imgs, masks, bboxes):
        c_imgs = to_unit_float(c_imgs)
        masked = c_imgs * as_bool_mask(masks).to(c_imgs.dtype)
        irises = gray_to_rgb(crop_and_resize(masked, bboxes, CROP))  # (B, 224, 224, 3)
        final, _, style = VGG19.apply(vgg_params, irises.permute(0, 3, 1, 2), compute_dtype=compute_dtype)
        return irises, Classifier1.apply(c1, final), Classifier2.apply(c2, style)

    @torch.no_grad()
    def post_fn(vgg_params, c1, c2, frames, stylized, masks, bboxes):
        """``stylized`` is the NST output, (B, 3, 224, 224)."""
        frames = to_unit_float(frames)
        masks = as_bool_mask(masks)
        new_frames = composite_batch(frames, stylized.permute(0, 2, 3, 1), masks, bboxes)
        masked = new_frames * masks.to(new_frames.dtype)
        irises = gray_to_rgb(crop_and_resize(masked, bboxes, CROP))
        final, _, style = VGG19.apply(vgg_params, irises.permute(0, 3, 1, 2), compute_dtype=compute_dtype)
        return new_frames, Classifier1.apply(c1, final), Classifier2.apply(c2, style)

    @torch.no_grad()
    def post_seg(ritnet_params, new_frames, seg_gt, chunk: int | None = None):
        """RITnet re-segmentation + per-class IoU, chunked; returns the
        per-chunk (4, chunk) IoU tensors, still on the device."""
        chunk = chunk or seg_chunk
        parts = []
        for i in range(0, new_frames.shape[0], chunk):
            seg = RITnet.apply(ritnet_params, new_frames[i : i + chunk])
            gt = as_label_map(seg_gt[i : i + chunk], seg.shape[-1])
            parts.append(iou_per_class(seg, gt)[0])
        return parts

    return pre_fn, post_fn, post_seg


def _cpu_metrics(labels, logits, num_class: int, **kw) -> dict[str, float]:
    m = classification_metrics(torch.as_tensor(labels), logits.float().cpu(), num_class, **kw)
    return {k: float(v) for k, v in m.items()}


def _batch_metric_job(metric_prefix, num_class, phase, yy, ys, valid, p1, p2):
    """Per-batch classification metrics for one phase (pre/post)."""
    vt = torch.as_tensor(valid)
    p1v, p2v = p1.cpu()[vt], p2.cpu()[vt]
    out = {}
    for nm, pred in (("c1", p1v), ("c2", p2v)):
        m = _cpu_metrics(yy, pred, num_class, auc_present_only=True)
        out.update({f"{metric_prefix}{phase}/{nm}/batch/{k}": v for k, v in m.items()})
        m = _cpu_metrics(ys, pred, num_class, auc_present_only=True)
        out.update({f"{metric_prefix}{phase}/{nm}/mis/batch/{k}": v for k, v in m.items()})
    return out, {f"{phase}1": p1v, f"{phase}2": p2v}


def _loss_job(metric_prefix, c_hist, s_hist, c_w, s_w):
    c_loss, s_loss = float(c_hist[-1].item()), float(s_hist[-1].item())
    log = {
        f"{metric_prefix}/batch/c_loss": c_loss,
        f"{metric_prefix}/batch/s_loss": s_loss,
        f"{metric_prefix}/batch/cs_loss": c_loss * c_w + s_loss * s_w,
    }
    return log, {"c_loss": c_loss, "s_loss": s_loss}


def _seg_iou_job(metric_prefix, parts, valid):
    ious = torch.cat(parts, dim=1).cpu().numpy()
    miou = np.mean(ious, axis=0, dtype=np.float32)
    ious_v = ious[:, valid]
    log = {f"{metric_prefix}post/batch/iou{c}": float(np.nanmean(ious_v[c])) for c in range(4)}
    log[f"{metric_prefix}post/batch/miou"] = float(np.nanmean(miou[valid]))
    return log, {"ious": ious_v, "mious": miou[valid]}


def _load_head(path: str, head: str, default: dict, device) -> dict:
    """A classifier's parameters from ``path`` (an exact checkpoint file, or
    a directory's latest step), or ``default`` when no path is given.  A
    checkpoint of ``workloads/iris_classification.py`` holds both heads,
    under ``c1`` and ``c2``; ``head`` picks one."""
    params = restore_params(path, default, device)
    return params[head] if head in params else params


def iris_style_transfer_openeds2019(
    cfg: WorkloadConfig,
    dataset,
    vgg_params,
    ritnet_params,
    c1_params,
    c2_params,
    c_loss_weight: float,
    s_loss_weight: float,
    nst_epoch: int,
    metric_prefix: str,
    save_dir: str,
    logger: MetricLogger,
    device: torch.device,
    save_period: int = 50,
    num_class: int = 152,
    programs=None,
    mesh: Mesh | None = None,
) -> dict:
    """One sweep combo over ``dataset``; with ``mesh`` (None: ``device``
    alone) each rank runs its block of every batch, and rank 0 writes."""
    mesh = mesh if mesh is not None else one_rank(device)
    compute_dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
    if programs is None:
        programs = make_programs(compute_dtype)
    pre_fn, post_fn, post_seg = programs
    nst_fn = cached_nst_program(
        nst_epoch, float(c_loss_weight), float(s_loss_weight), cfg.compute_dtype, cfg.history_size,
        cfg.stats_taps, mesh,
    )

    agg = {k: [] for k in ("pre1", "pre2", "post1", "post2", "c_labels", "s_labels",
                           "ious", "mious", "c_loss", "s_loss")}
    timer = StepTimer()
    metric_pool = ThreadPoolExecutor(max_workers=1)
    pending: list[tuple[dict, list]] = []
    pipe_times: list[float] = []

    new_run()
    batches = iter(batch_iterator(
        (dataset.c_imgs, dataset.c_labels, dataset.c_masks_iris, dataset.c_iris_bbs,
         dataset.c_masks_gt, dataset.s_irises, dataset.s_labels),
        cfg.bs,
        pad_final=True,
    ))
    try:
        for batch_id in itertools.count():
            at_batch(batch_id)
            with span("ist.load"):
                batch = next(batches, None)
                t_batch = time.perf_counter()
                if batch is not None:
                    # this rank's block; the labels and valid rows stay global on the host
                    c_imgs, masks, bboxes, seg_gt, s_irises = shard_batch(mesh, (batch[0], *batch[2:6]))
                    c_labels, s_labels = batch[1], batch[6]
                    valid = batch[7] if len(batch) > 7 else np.ones(len(c_labels), bool)
            if batch is None:
                break
            with span("ist.pre"):  # the program, and its metrics handed to the worker
                irises, p1, p2 = pre_fn(vgg_params, c1_params, c2_params, c_imgs, masks, bboxes)
                yy = np.asarray(c_labels)[valid]
                ys = np.asarray(s_labels)[valid]
                futs = [metric_pool.submit(
                    job("ist.metric_job", _batch_metric_job), metric_prefix, num_class, "pre", yy, ys, valid,
                    gather_batch(mesh, p1), gather_batch(mesh, p2),
                )]
                agg["c_labels"].append(yy)
                agg["s_labels"].append(ys)
                s_rgb = gray_to_rgb(to_unit_float(s_irises)).permute(0, 3, 1, 2)
                rows = height_sharding(mesh, CROP[0])  # this rank's slab of the irises' H

            if batch_id % save_period == 0 and mesh.is_main:
                with span("ist.save"):
                    save_png(f"{save_dir}batch_{batch_id}_raw.png", batch[0][0].cpu().numpy())
                    save_png(f"{save_dir}batch_{batch_id}_sty.png", batch[5][0].cpu().numpy())

            with timer:
                with span("ist.nst"):
                    result = nst_fn(vgg_params, irises.permute(0, 3, 1, 2)[:, :, rows], s_rgb[:, :, rows])
                    stylized = gather_height(mesh, result.x)
                with span("ist.nst_sync"):
                    _sync(device)

            with span("ist.post"):  # the NST's losses handed to the worker, then the program
                futs.append(metric_pool.submit(
                    job("ist.metric_job", _loss_job), metric_prefix, result.c_loss_hist, result.s_loss_hist,
                    c_loss_weight, s_loss_weight,
                ))
                new_frames, p1, p2 = post_fn(vgg_params, c1_params, c2_params, c_imgs, stylized, masks, bboxes)
            with span("ist.seg"):  # the program, then the post metrics and IoUs handed to the worker
                seg_parts = post_seg(ritnet_params, new_frames, seg_gt)
                if mesh.batch_shards > 1:  # (4, B / n) per rank -> (4, B)
                    seg_parts = [gather_batch(mesh, torch.cat(seg_parts, dim=1).t().contiguous()).t()]
                futs.append(metric_pool.submit(
                    job("ist.metric_job", _batch_metric_job), metric_prefix, num_class, "post", yy, ys, valid,
                    gather_batch(mesh, p1), gather_batch(mesh, p2),
                ))
                futs.append(metric_pool.submit(job("ist.metric_job", _seg_iou_job), metric_prefix, seg_parts,
                                               valid))

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
        ious = np.concatenate(agg["ious"], axis=1)
        mious = np.concatenate(agg["mious"])
        if mesh.is_main:
            for c in range(4):
                np.save(f"{save_dir}ious{c}_post.npy", ious[c])
            np.save(f"{save_dir}mious_post.npy", mious)
        for c in range(4):
            log[f"{metric_prefix}post/mean_iou{c}"] = float(np.nanmean(ious[c]))
        log[f"{metric_prefix}post/mean_miou"] = float(np.nanmean(mious))

        c_loss = float(np.nanmean(agg["c_loss"]))
        s_loss = float(np.nanmean(agg["s_loss"]))
        log[f"{metric_prefix}/c_loss"] = c_loss
        log[f"{metric_prefix}/s_loss"] = s_loss
        log[f"{metric_prefix}/cs_loss"] = c_loss * c_loss_weight + s_loss * s_loss_weight

        yy = np.concatenate(agg["c_labels"])
        ys = np.concatenate(agg["s_labels"])
        for phase in ("pre", "post"):
            for nm in ("1", "2"):
                pred = torch.cat(agg[f"{phase}{nm}"])
                m = _cpu_metrics(yy, pred, num_class)
                log.update({f"{metric_prefix}{phase}/c{nm}/{k}": v for k, v in m.items()})
                m = _cpu_metrics(ys, pred, num_class)
                log.update({f"{metric_prefix}{phase}/c{nm}/mis/{k}": v for k, v in m.items()})
        log[f"{metric_prefix}nst_batches_per_sec"] = timer.per_sec()
        log[f"{metric_prefix}stylized_images_per_min"] = timer.per_sec(cfg.bs) * 60
        # end to end: the first (warm-up) batch is excluded when there are more
        pipe = pipe_times[1:] if len(pipe_times) > 1 else pipe_times
        if pipe:
            log[f"{metric_prefix}pipeline_images_per_min"] = cfg.bs * len(pipe) / (sum(pipe) + t_drain) * 60
        logger.log(log)
    return log


def main(argv: list[str] | None = None):
    parser = argparse.ArgumentParser()
    defaults = WorkloadConfig(project="iris-style-transfer-openeds2019", bs=64)
    add_common_args(parser, defaults)
    parser.add_argument("-path1", "--classifier1_path", type=str, default="")
    parser.add_argument("-path2", "--classifier2_path", type=str, default="")
    parser.add_argument("--vgg_weights", type=str, default="",
                        help="ported VGG19 IMAGENET1K_V1 npz in the JAX package's format")
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
    base = os.path.join(cfg.data_dir, "openeds2019")
    if os.path.isdir(base):
        data = load_data_openeds2019(cfg.test_split_ratio, load_seg=True, data_dir=base)
    else:
        print(f"[data] {base} not found -> synthetic dataset")
        data = synthetic_openeds2019(n_per_user=6, num_users=8, seed=cfg.seed)
    train_x, train_y, train_m, test_x, test_y, test_m, num_class = data
    print("number of classes:", num_class)

    vgg_params = load_pretrained("vgg19", args.vgg_weights, lambda: VGG19.init(gen, device), device)
    ritnet_params = RITnet.pretrained(device)
    c1_params = _load_head(args.classifier1_path, "c1", Classifier1.init(gen, num_class, device), device)
    c2_params = _load_head(args.classifier2_path, "c2", Classifier2.init(gen, num_class=num_class, device=device),
                           device)
    vgg_params, ritnet_params, c1_params, c2_params = (
        replicated(mesh, p) for p in (vgg_params, ritnet_params, c1_params, c2_params))

    presentation = {"name", "project", "num_workers", "resume", "save_period"}
    sweep_config = {k: v for k, v in cfg.to_dict().items() if k not in presentation}
    sweep_config.update(vgg_weights=args.vgg_weights, classifier1_path=args.classifier1_path,
                        classifier2_path=args.classifier2_path)

    splits = [("test/", test_x, test_y, test_m)]
    if cfg.eval_train:
        splits.append(("train/", train_x, train_y, train_m))
    results = {}
    compute_dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
    programs = make_programs(compute_dtype)

    for prefix, xs, ys_, ms in splits:
        dataset = build_ist_dataset(xs, ys_, ms, ritnet_params, cfg.glint_threshold, device=device)
        for sw in args.s_loss_weights:
            for nst_epoch in args.nst_epochs:
                save_dir = f"saved/openeds2019/sw_{sw}_epoch_{nst_epoch}/{prefix}"
                done_marker = os.path.join(save_dir, "done.json")
                barrier(mesh)  # rank 0's markers are written before any rank reads them
                if sweep_done(done_marker, sweep_config, defaults=WorkloadConfig().to_dict()) and not args.rerun:
                    print(f"[sweep] {save_dir} already complete, skipping")
                    continue
                if mesh.is_main:
                    prepare_dir(save_dir, idempotent=True)
                name = f"seed {cfg.seed} sw {sw} epoch {nst_epoch} {prefix[:-1]}"
                logger = MetricLogger(cfg.project, name, cfg.to_dict(), enabled=mesh.is_main)
                log = iris_style_transfer_openeds2019(
                    cfg, dataset, vgg_params, ritnet_params, c1_params, c2_params,
                    cfg.c_loss_weight, sw, nst_epoch, prefix, save_dir, logger, device,
                    num_class=num_class, programs=programs, mesh=mesh,
                )
                pre_log = {}
                for c in range(4):
                    pre_log[f"{prefix}pre/mean_iou{c}"] = float(np.nanmean(dataset.ious[c]))
                pre_log[f"{prefix}pre/mean_miou"] = float(np.nanmean(dataset.mious))
                if mesh.is_main:
                    for c in range(4):
                        np.save(f"{save_dir}ious{c}_pre.npy", dataset.ious[c])
                    np.save(f"{save_dir}mious_pre.npy", dataset.mious)
                logger.log(pre_log)
                logger.finish()
                if mesh.is_main:
                    write_sweep_marker(done_marker, sweep_config, log)
                results[(prefix, sw, nst_epoch)] = log
    return results


if __name__ == "__main__":
    main()
