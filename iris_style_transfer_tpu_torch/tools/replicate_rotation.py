"""Rotation and perspective robustness of the two classifier heads on the
synthetic twin: do style features identify users more robustly than CNN
features as the test irises are rotated or perspective-warped?

Counterpart of the repository's ``tools/replicate_rotation.py``, with its
flags and summary keys (plus ``--device``).  Eval-only, on the stage-1
checkpoint of ``replicate_synthetic`` (``--ckpt``):

  1. Rebuild the same twin (same seed) and the VGG19 the heads were
     trained against (``seeded_vgg19``).
  2. Masked-crop the held-out test irises from the ground-truth
     segmentations.
  3. For each distortion level, warp the crops with the warps of the
     training augmentation (``ops/image.py:rotate`` / ``perspective_warp``),
     symmetric +-angle rotations and two seeded perspective draws averaged.
  4. Classify with both heads; report accuracy and retention (accuracy at
     a level / accuracy at 0) per head.

The claim replicates iff Classifier2's retention stays above Classifier1's
as the distortion grows.

    python -m iris_style_transfer_tpu_torch.tools.replicate_rotation \\
        --ckpt saved/checkpoints/iris_classification \\
        [--angles 0,15,30,45,90,180 --pers 0,0.2,0.4,0.6 --out results_rotation]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..data import synthetic_openeds2019
from ..models import Classifier1, Classifier2, VGG19
from ..ops.image import (crop_and_resize, gray_to_rgb, nonzero_bbox, perspective_warp, random_perspective_params,
                         rotate, to_unit_float)
from ..pipelines.iris import iris_mask_from_seg
from ..runtime import restore_params
from ..runtime.config import resolve_device
from ..workloads.iris_classification import seeded_vgg19
from .replicate_synthetic import stage_done, write_summary


@torch.no_grad()
def masked_test_crops(test_x, test_m, glint_threshold: float = 0.8, out_size=(224, 224), chunk: int = 8,
                      device="cpu") -> torch.Tensor:
    """Iris crops from the ground-truth segmentations, in chunks of
    ``chunk`` frames: iris mask (class 2 and below the glint threshold),
    crop to the masked frame's extent, resize.  uint8 frames are
    dequantized first, so the threshold sees [0,1] values.  Returns
    (N, *out_size, 1) float32 crops on ``device``."""
    out = []
    for i in range(0, len(test_x), chunk):
        frames = to_unit_float(torch.from_numpy(np.stack(test_x[i : i + chunk])).to(device))
        segs = torch.from_numpy(np.stack(test_m[i : i + chunk]).astype(np.int64)).to(device)
        masked = frames * iris_mask_from_seg(segs, frames, glint_threshold).to(frames.dtype)
        out.append(crop_and_resize(masked, nonzero_bbox(masked[..., 0]), out_size))
    return torch.cat(out)


def _warp_all(crops: torch.Tensor, warp) -> torch.Tensor:
    """One warp of every (H, W, 1) crop: the batch rides the channel axis,
    since every crop takes the same sampling grid."""
    return warp(crops[..., 0].permute(1, 2, 0)).permute(2, 0, 1)[..., None]


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", type=str, default="saved/checkpoints/iris_classification")
    ap.add_argument("--users", type=int, default=8)
    ap.add_argument("--n_per_user", type=int, default=24)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--angles", type=str, default="0,15,30,45,90,180")
    ap.add_argument("--pers", type=str, default="0,0.2,0.4,0.6")
    ap.add_argument("--chunk", type=int, default=8)
    ap.add_argument("--crop_size", type=int, default=224, help="masked-crop resolution (smaller = smoke tests)")
    ap.add_argument("--out", type=str, default="")
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device to run on; a CUDA request without CUDA fails")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    t = time.perf_counter()
    _, _, _, test_x, test_y, test_m, num_class = synthetic_openeds2019(
        n_per_user=args.n_per_user, num_users=args.users, seed=args.seed)
    labels = np.asarray(test_y)
    print(f"twin test split: {len(test_x)} frames, {num_class} users", flush=True)
    crops = masked_test_crops(test_x, test_m, out_size=(args.crop_size, args.crop_size), device=device)
    print(f"masked GT-seg crops: {tuple(crops.shape)}", flush=True)

    vgg_params, _ = seeded_vgg19(args.seed, device)  # the VGG19 the heads were trained against
    heads = restore_params(args.ckpt, None, device)

    @torch.no_grad()
    def accuracy(batch: torch.Tensor) -> tuple[float, float]:
        """Both heads' accuracy over the crops, in chunks of ``--chunk``
        (the last one padded with its last crop)."""
        pred1, pred2 = [], []
        n = len(batch)
        for i in range(0, n, args.chunk):
            b = batch[i : i + args.chunk]
            if len(b) < args.chunk:
                b = torch.cat([b, b[-1:].expand(args.chunk - len(b), -1, -1, -1)])
            final, _, style = VGG19.apply(vgg_params, gray_to_rgb(b).permute(0, 3, 1, 2))
            pred1.append(Classifier1.apply(heads["c1"], final).argmax(-1)[: n - i])
            pred2.append(Classifier2.apply(heads["c2"], style).argmax(-1)[: n - i])
        p1, p2 = torch.cat(pred1).cpu().numpy(), torch.cat(pred2).cpu().numpy()
        return float((p1 == labels).mean()), float((p2 == labels).mean())

    def mean_of(accs: list[tuple[float, float]]) -> tuple[float, float]:
        return float(np.mean([a[0] for a in accs])), float(np.mean([a[1] for a in accs]))

    results = {"chance": 1.0 / num_class}
    rows = []
    for ang in [float(a) for a in args.angles.split(",")]:
        if ang == 0.0:
            a1, a2 = accuracy(crops)
        else:  # symmetric draws, averaged (the training augmentation is U(-d, d))
            a1, a2 = mean_of([accuracy(_warp_all(crops, lambda im: rotate(im, s * ang, mode="nearest")))
                              for s in (+1, -1)])
        results[f"rot/{ang:g}/c1"], results[f"rot/{ang:g}/c2"] = a1, a2
        rows.append(("rot", ang, a1, a2))
        print(f"rotation {ang:5g} deg: c1 {a1:.3f}  c2 {a2:.3f}", flush=True)

    h, w = crops.shape[1:3]
    for dist in [float(p) for p in args.pers.split(",")]:
        if dist == 0.0:
            a1, a2 = accuracy(crops)
        else:  # two seeded draws of the corners, averaged
            accs = []
            for rep in range(2):
                sp, ep = random_perspective_params(torch.Generator().manual_seed(100 + rep), h, w, dist)
                accs.append(accuracy(_warp_all(crops, lambda im: perspective_warp(im, sp.to(device), ep.to(device)))))
            a1, a2 = mean_of(accs)
        results[f"pers/{dist:g}/c1"], results[f"pers/{dist:g}/c2"] = a1, a2
        rows.append(("pers", dist, a1, a2))
        print(f"perspective {dist:4g}: c1 {a1:.3f}  c2 {a2:.3f}", flush=True)

    # retention = acc(level) / acc(0) per head; the claim is c2 >= c1 as
    # the distortion grows
    for kind in ("rot", "pers"):
        base = [(a1, a2) for k, lv, a1, a2 in rows if k == kind and lv == 0]
        if not base:
            continue
        b1, b2 = base[0]
        for k, lv, a1, a2 in rows:
            if k == kind and lv != 0:
                results[f"{kind}/{lv:g}/retention_c1"] = a1 / max(b1, 1e-9)
                results[f"{kind}/{lv:g}/retention_c2"] = a2 / max(b2, 1e-9)
    stage_done("twin, crops and every distortion", t)
    return write_summary(results, args.out)


if __name__ == "__main__":
    main()
