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

Its sweep's loop, metric worker, spans and mesh are
``workloads/sweep.py``'s; its host metric work is sklearn-equivalent
metrics on the logits and the IoU read-backs, and its own span is
``ist.seg`` a batch.  On a mesh RITnet and the classifiers run on the
rank's block, and the logits and IoUs are gathered, so the per-batch and
epoch metrics are the global batch's.  With ``--data_dir/openeds2019``
present the run reads that OpenEDS2019 tree, with its segmentation labels
(``data/openeds2019.py:load_data_openeds2019``); without it, the synthetic
twin.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..data import batch_iterator, build_ist_dataset, load_data_openeds2019, synthetic_openeds2019
from ..models import Classifier1, Classifier2, RITnet, VGG19, load_pretrained
from ..ops.image import as_bool_mask, as_label_map, crop_and_resize, gray_to_rgb, to_unit_float
from ..ops.metrics import classification_metrics, iou_per_class
from ..parallel.mesh import Mesh, gather_batch, height_sharding, one_rank, replicated, shard_batch
from ..pipelines import composite_batch
from ..runtime import MetricLogger, WorkloadConfig, restore_params
from ..runtime.profiler import span
from ..transfer.nst import cached_nst_program
from ..utils import seed as seed_all
from .sweep import CROP, Sweep, run_combos, sweep_main


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


def _cpu_metrics(out: dict, key: str, labels, logits, num_class: int, **kw) -> None:
    m = classification_metrics(torch.as_tensor(labels), logits.float().cpu(), num_class, **kw)
    out.update({f"{key}/{k}": float(v) for k, v in m.items()})


def _batch_metric_job(metric_prefix, num_class, phase, yy, ys, valid, p1, p2):
    """Per-batch classification metrics for one phase (pre/post)."""
    vt = torch.as_tensor(valid)
    p1v, p2v = p1.cpu()[vt], p2.cpu()[vt]
    out = {}
    for nm, pred in (("c1", p1v), ("c2", p2v)):
        _cpu_metrics(out, f"{metric_prefix}{phase}/{nm}/batch", yy, pred, num_class, auc_present_only=True)
        _cpu_metrics(out, f"{metric_prefix}{phase}/{nm}/mis/batch", ys, pred, num_class, auc_present_only=True)
    return out, {f"{phase}1": p1v, f"{phase}2": p2v}


def _seg_iou_job(metric_prefix, parts, valid):
    ious = torch.cat(parts, dim=1).cpu().numpy()
    miou = np.mean(ious, axis=0, dtype=np.float32)
    ious_v = ious[:, valid]
    log = {f"{metric_prefix}post/batch/iou{c}": float(np.nanmean(ious_v[c])) for c in range(4)}
    log[f"{metric_prefix}post/batch/miou"] = float(np.nanmean(miou[valid]))
    return log, {"ious": ious_v, "mious": miou[valid]}


def _iou_log(metric_prefix, phase, ious, mious, save_dir: str, is_main: bool) -> dict[str, float]:
    """The mean IoU of each class and the mean mIoU of one phase (pre or
    post the NST); rank 0 saves the arrays."""
    if is_main:
        for c in range(4):
            np.save(f"{save_dir}ious{c}_{phase}.npy", ious[c])
        np.save(f"{save_dir}mious_{phase}.npy", mious)
    log = {f"{metric_prefix}{phase}/mean_iou{c}": float(np.nanmean(ious[c])) for c in range(4)}
    log[f"{metric_prefix}{phase}/mean_miou"] = float(np.nanmean(mious))
    return log


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
    sweep = Sweep(mesh, device, metric_prefix, save_dir, save_period, c_loss_weight, s_loss_weight)

    def unpack(batch):  # this rank's block; the labels and valid rows stay global on the host
        block = shard_batch(mesh, (batch[0], *batch[2:6]))
        return batch, *block, batch[7] if len(batch) > 7 else np.ones(len(batch[1]), bool)

    def body(batch, c_imgs, masks, bboxes, seg_gt, s_irises, valid):
        with span("ist.pre"):  # the program, and its metrics handed to the worker
            irises, p1, p2 = pre_fn(vgg_params, c1_params, c2_params, c_imgs, masks, bboxes)
            yy = np.asarray(batch[1])[valid]
            ys = np.asarray(batch[6])[valid]
            sweep.submit(_batch_metric_job, metric_prefix, num_class, "pre", yy, ys, valid,
                         gather_batch(mesh, p1), gather_batch(mesh, p2))
            sweep.agg["c_labels"].append(yy)
            sweep.agg["s_labels"].append(ys)
            s_rgb = gray_to_rgb(to_unit_float(s_irises)).permute(0, 3, 1, 2)
            rows = height_sharding(mesh, CROP[0])  # this rank's slab of the irises' H
        sweep.save(raw=batch[0], sty=batch[5])
        with sweep.nst(lambda: nst_fn(vgg_params, irises.permute(0, 3, 1, 2)[:, :, rows],
                                      s_rgb[:, :, rows])) as stylized:
            new_frames, p1, p2 = post_fn(vgg_params, c1_params, c2_params, c_imgs, stylized, masks, bboxes)
        with span("ist.seg"):  # the program, then the post metrics and IoUs handed to the worker
            seg_parts = post_seg(ritnet_params, new_frames, seg_gt)
            if mesh.batch_shards > 1:  # (4, B / n) per rank -> (4, B)
                seg_parts = [gather_batch(mesh, torch.cat(seg_parts, dim=1).t().contiguous()).t()]
            sweep.submit(_batch_metric_job, metric_prefix, num_class, "post", yy, ys, valid,
                         gather_batch(mesh, p1), gather_batch(mesh, p2))
            sweep.submit(_seg_iou_job, metric_prefix, seg_parts, valid)
        sweep.save(new=new_frames)

    arrays = (dataset.c_imgs, dataset.c_labels, dataset.c_masks_iris, dataset.c_iris_bbs, dataset.c_masks_gt,
              dataset.s_irises, dataset.s_labels)
    agg = sweep.run(batch_iterator(arrays, cfg.bs, pad_final=True), unpack, body, logger)

    with span("ist.aggregate"):
        log = _iou_log(metric_prefix, "post", np.concatenate(agg["ious"], axis=1), np.concatenate(agg["mious"]),
                       save_dir, mesh.is_main)
        log.update(sweep.loss_means())

        yy = np.concatenate(agg["c_labels"])
        ys = np.concatenate(agg["s_labels"])
        for phase in ("pre", "post"):
            for nm in ("1", "2"):
                pred = torch.cat(agg[f"{phase}{nm}"])
                _cpu_metrics(log, f"{metric_prefix}{phase}/c{nm}", yy, pred, num_class)
                _cpu_metrics(log, f"{metric_prefix}{phase}/c{nm}/mis", ys, pred, num_class)
        log.update({f"{metric_prefix}{k}": v for k, v in sweep.rates(cfg.bs).items()})
        logger.log(log)
    return log


def main(argv: list[str] | None = None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-path1", "--classifier1_path", type=str, default="")
    parser.add_argument("-path2", "--classifier2_path", type=str, default="")
    return sweep_main(main, argv, parser, WorkloadConfig(project="iris-style-transfer-openeds2019", bs=64), _sweeps)


def _sweeps(cfg: WorkloadConfig, args, mesh: Mesh) -> dict:
    """Every combo of the test split, and with ``--eval_train`` the train split."""
    device = mesh.device
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

    splits = [("test/", test_x, test_y, test_m)]
    if cfg.eval_train:
        splits.append(("train/", train_x, train_y, train_m))
    results = {}
    compute_dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
    programs = make_programs(compute_dtype)

    for prefix, xs, ys_, ms in splits:
        dataset = build_ist_dataset(xs, ys_, ms, ritnet_params, cfg.glint_threshold, device=device)

        def run(sw, nst_epoch, save_dir, logger):
            log = iris_style_transfer_openeds2019(
                cfg, dataset, vgg_params, ritnet_params, c1_params, c2_params,
                cfg.c_loss_weight, sw, nst_epoch, prefix, save_dir, logger, device,
                num_class=num_class, programs=programs, mesh=mesh,
            )
            logger.log(_iou_log(prefix, "pre", dataset.ious, dataset.mious, save_dir, mesh.is_main))
            return log

        results |= run_combos(cfg, args, mesh, "openeds2019", prefix, prefix[:-1], run,
                              vgg_weights=args.vgg_weights, classifier1_path=args.classifier1_path,
                              classifier2_path=args.classifier2_path)
    return results


if __name__ == "__main__":
    main()
