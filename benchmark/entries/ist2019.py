"""The 2019 IST main's sweep (``workloads/ist_openeds2019.py``), driven as
one pass over a twin dataset of K batches.

Set-up makes the seeded weights on the card, reads RITnet's bundled
weights, warms every shape the pass uses with a short NST (the programs
are the pass's), times two short passes to size K to ``--seconds``, and
builds the pass's ``ISTDataset`` with the port's RITnet
(``build_ist_dataset``).  The measured pass is one call of
``iris_style_transfer_openeds2019`` with ``programs=`` the port's own
``make_programs``, wrapped by a recorder that keeps what each program
returns and times it in CUDA events, and by ``taps.StepTap``, which
keeps what the NST of one sampled batch hands its L-BFGS (``taps.ApplyTap``
keeps RITnet's labels inside the re-segmentation).  The check judges
those outputs, the NST's output as ``post_fn`` receives it, and
the dataset's masks, boxes and donor crops, against the reference.
"""

from __future__ import annotations

import os
import random

import torch

from benchmark import twin, weights
from benchmark.checks import iou, label_gap_of, nst_gaps, rel_gap, seg_gap, unpack_bits
from benchmark.reference import image as ref_image
from benchmark.reference import lbfgs as ref_lbfgs
from benchmark.reference import ritnet as ref_ritnet
from benchmark.reference import vgg as ref_vgg
from benchmark.reference.precision import BF16, F32, Precision, exact_f32
from benchmark.sweep import Recorder, SweepEntry
from benchmark.taps import ApplyTap, as_step
from benchmark.work import classifiers as work_heads
from benchmark.work import conv1 as work_conv1
from benchmark.work import relu_pool as work_relu_pool
from benchmark.work import ritnet as work_ritnet
from benchmark.work import vgg19 as work_vgg

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
RITNET_NPZ = ("iris_style_transfer_tpu", "models", "weights", "ritnet.npz")
PREFIX = "test/"
WARM_STREAM = 1_000_000  # twin batches of the warm-up, apart from the pass's 0 .. K-1
# the traced slice's kernels: the VGG path's hand-written ones
VGG_KERNELS = ("relu_pool_fwd_kernel", "relu_pool_bwd_kernel", "conv1_mma_kernel")


class Programs(Recorder):
    """The 2019 main's three programs (pre, post, re-segmentation), and the
    labels RITnet gives inside the last."""

    def __init__(self, programs, device):
        super().__init__(device)
        self.fns = programs
        self.seg_tap = ApplyTap("iris_style_transfer_tpu_torch.workloads.ist_openeds2019", "RITnet", self)

    def pre(self, *args):
        self.next_batch()
        out = self.timed(self.fns[0], *args)
        if self.keeping:
            self.batches[self.index] = {"irises": out[0], "p1": out[1], "p2": out[2]}
        return out

    def post(self, vgg, c1, c2, frames, stylized, masks, bboxes):
        out = self.timed(self.fns[1], vgg, c1, c2, frames, stylized, masks, bboxes)
        if self.keeping:
            self.batches[self.index].update(stylized=stylized, new_frames=out[0], q1=out[1], q2=out[2])
        return out

    def seg(self, *args, **kw):
        out = self.timed(self.fns[2], *args, **kw)
        if self.keeping:
            self.batches[self.index].update(iou=torch.cat(out, dim=1), labels=self.seg_tap.take())
        return out

    def programs(self):
        return self.pre, self.post, self.seg


def donors(labels: list[int], seed: int) -> list[int]:
    """The style donor of each frame: another user's frame, drawn by
    rejection from ``random`` seeded with ``seed``, in frame order."""
    rng = random.Random(seed)
    out = []
    for lab in labels:
        j = rng.randrange(len(labels))
        while labels[j] == lab:
            j = rng.randrange(len(labels))
        out.append(j)
    return out


class Entry(SweepEntry):
    main = "iris_style_transfer_tpu_torch.workloads.ist_openeds2019"

    def __init__(self, run):
        super().__init__(run)
        self.num_class = self.cfg_json["num_classes"]

    # ------------------------------------------------------------------ set-up
    def _frames(self, batch: int) -> dict:
        return twin.eyes(self.seed, batch, self.bs, self.num_class, *self.hw, device=self.device)

    def _dataset(self, batches: list[int], donor_seed: int):
        from iris_style_transfer_tpu_torch.data import build_ist_dataset

        parts = [self._frames(b) for b in batches]
        frames = torch.cat([p["frames"] for p in parts])
        labels = torch.cat([p["labels"] for p in parts])
        users = torch.cat([p["users"] for p in parts]).tolist()
        random.seed(donor_seed)
        ds = build_ist_dataset(list(frames.cpu().numpy()), users, list(labels.cpu().numpy()), self.ritnet,
                               self.cfg_json["glint_threshold"], device=self.device)
        return ds, {"frames": frames, "labels": labels, "users": users, "donor_seed": donor_seed}

    def _sweep(self, dataset, closures: int) -> dict:
        from iris_style_transfer_tpu_torch.workloads.ist_openeds2019 import iris_style_transfer_openeds2019

        return iris_style_transfer_openeds2019(
            self.cfg, dataset, self.vgg, self.ritnet, self.c1, self.c2, self.cfg_json["c_loss_weight"],
            self.cfg_json["s_loss_weight"], closures, PREFIX, self.tmp, self.logs, self.device,
            num_class=self.num_class, programs=self.rec.programs(),
        )

    def setup(self) -> None:
        from iris_style_transfer_tpu_torch.models import RITnet
        from iris_style_transfer_tpu_torch.workloads.ist_openeds2019 import make_programs

        dtype = self._begin()
        self.vgg = weights.vgg19(self.seed, self.device)
        self.c1, self.c2 = weights.mlp_heads(
            self.seed, [(25088, 4096, 4096, self.num_class), (1920, 4096, 4096, self.num_class)], self.device)
        self.ritnet = RITnet.pretrained(self.device)
        self.rec = Programs(make_programs(dtype), self.device)
        self.warm, _ = self._dataset([WARM_STREAM], self.seed + 1)
        self.batches = self._size(self.warm)
        self.dataset, self.inputs = self._dataset(list(range(self.batches)), self.seed + 2)

    # ------------------------------------------------------------ the window
    def timed_pass(self) -> dict:
        wall, log = self._pass(self.dataset, None)
        return self._timed(wall, log[f"{PREFIX}nst_batches_per_sec"])

    def traced_slice(self):
        from benchmark import trace

        prof, wall, _ = trace.traced(lambda: self._sweep(self.warm, self.closures),
                                     trace.has_kernels(VGG_KERNELS), "one batch of the 2019 sweep")
        return trace.summarize(prof, wall)

    # ------------------------------------------------------------ the work
    def work(self) -> dict:
        """Per batch: the model FLOPs, and each VGG kernel's launches and
        bound in seconds."""
        b, n = self.bs, self.closures
        vgg_full = work_vgg.forward_flops(b)
        heads = work_heads.flops(b, self.num_class)
        nst = 2 * work_vgg.nst_forward_flops(b) + n * work_vgg.nst_closure_flops(b)
        reseg = work_ritnet.flops(b, *self.hw)
        passes = 2 + 2 + n  # VGG forwards: pre, post, the two targets, one a closure
        return {
            "flops": 2 * (vgg_full + heads) + nst + reseg,
            "kernels": {
                "relu_pool_fwd_kernel": (passes, work_relu_pool.fwd_bound_s(b, 64, 224, 224)),
                "relu_pool_bwd_kernel": (n, work_relu_pool.bwd_bound_s(b, 64, 224, 224)),
                "conv1_mma_kernel": (passes, work_conv1.bound_s(b, 3, 64, 224, 224)),
            },
        }

    # ------------------------------------------------------------ the check
    def release(self) -> None:
        """Drop the program's state that the check does not read."""
        self.rec.seg_tap.close()
        self._end()
        self.warm = None

    def outputs(self) -> dict:
        """What the program produced: the dataset's masks, boxes and donor
        crops; per batch the recorder's outputs; and, for the sampled
        batch, what its NST handed the L-BFGS at the kept closures."""
        ds = self.dataset
        return {"masks": unpack_bits(ds.c_masks_iris), "boxes": ds.c_iris_bbs.long(), "donor_crops": ds.s_irises,
                "batches": self.rec.batches,
                "nst": {k: as_step(r) for k, r in self.tap.records.items()}}

    def control_outputs(self, prec: Precision) -> dict:
        """The reference at ``prec`` in the program's place, on the pass's
        inputs, as :meth:`outputs` gives them: RITnet's masks, the boxes,
        the crops, both heads, the NST (with the sampled batch's kept
        closures), the composite and the re-segmentation."""
        c, inp, bs = self.cfg_json, self.inputs, self.bs
        with exact_f32(), torch.no_grad():
            rit = ref_ritnet.load_ritnet(os.path.join(ROOT, *RITNET_NPZ), self.device)
            frames = inp["frames"].float() / 255.0
            labels = ref_ritnet.segment_logits(rit, frames, prec).argmax(1)
            masks = ref_image.iris_mask(labels, frames, c["glint_threshold"])
            boxes = ref_image.bbox(masks)
            crops = ref_image.crop(frames * masks[..., None], boxes, prec=prec)
            q16 = torch.round(crops.clamp(0, 1) * 65535.0) / 65535.0
            donor = torch.as_tensor(donors(inp["users"], inp["donor_seed"]), device=self.device)
            batches, steps = {}, {}
            for b in range(self.batches):
                rows = slice(b * bs, (b + 1) * bs)
                irises = crops[rows].expand(-1, -1, -1, 3)
                x0 = irises.permute(0, 3, 1, 2)
                p1, p2 = ref_vgg.classifiers(self.vgg, self.c1, self.c2, x0, prec)
                stylized = x0
                if b == self.sampled:
                    style = q16[donor[rows]].expand(-1, -1, -1, 3).permute(0, 3, 1, 2)
                    loss = ref_vgg.NSTLoss(self.vgg, x0, style, c["c_loss_weight"], c["s_loss_weight"], prec)
                    stylized, _, rec = ref_lbfgs.lbfgs_nst(loss, x0, self.closures, c["lbfgs_history"], prec=prec,
                                                           record=(0, 1, self.closures - 1))
                    steps = {k: dict(r, lr=1.0, first=k == 0) for k, r in rec.items()}
                new = ref_image.composite(frames[rows], stylized, masks[rows], boxes[rows], prec)
                again = ref_image.crop(new * masks[rows, ..., None], boxes[rows], prec=prec)
                q1, q2 = ref_vgg.classifiers(self.vgg, self.c1, self.c2,
                                             again.expand(-1, -1, -1, 3).permute(0, 3, 1, 2), prec)
                seg = ref_ritnet.segment_logits(rit, new, prec).argmax(1)
                batches[b] = {"irises": irises, "p1": p1, "p2": p2, "stylized": stylized, "new_frames": new,
                              "q1": q1, "q2": q2, "iou": iou(seg, inp["labels"][rows].long()), "labels": seg}
        return {"masks": masks, "boxes": boxes, "donor_crops": q16[donor], "batches": batches, "nst": steps}

    def judge(self, out: dict | None = None) -> dict[str, float]:
        """The check's readings of ``out`` (the program's outputs when None)."""
        with exact_f32(), torch.no_grad():
            return self._judge(self.outputs() if out is None else out)

    def _judge(self, out: dict) -> dict[str, float]:
        c, inp, bs = self.cfg_json, self.inputs, self.bs
        rit = ref_ritnet.load_ritnet(os.path.join(ROOT, *RITNET_NPZ), self.device)
        frames = inp["frames"].float() / 255.0
        gate = frames[..., 0] <= c["glint_threshold"]
        masks, boxes = out["masks"], out["boxes"]
        mask_gap = crop_gap = comp_gap = pre_gap = post_gap = 0.0
        donor = torch.as_tensor(donors(inp["users"], inp["donor_seed"]), device=self.device)
        box_miss = float((ref_image.bbox(masks) != boxes).any(dim=1).sum())
        flips, own_boxes = 0.0, []  # the reference's own masks and boxes against the program's: not compared
        for i in range(0, frames.shape[0], 16):
            sl = slice(i, i + 16)
            logits = ref_ritnet.segment_logits(rit, frames[sl])
            mask_gap = max(mask_gap, seg_gap(logits, masks[sl], gate[sl]))
            own = ref_image.iris_mask(logits.argmax(1), frames[sl], c["glint_threshold"])
            flips += float((own != masks[sl]).sum())
            own_boxes.append(ref_image.bbox(own))
        box_flips = float((torch.cat(own_boxes) != boxes).any(dim=1).sum())
        ref_crops = ref_image.crop(frames * masks[..., None], boxes)
        q16 = torch.round(ref_crops.clamp(0, 1) * 65535.0) / 65535.0
        crop_gap = float((out["donor_crops"] - q16[donor]).abs().max())
        for b, rec in sorted(out["batches"].items()):
            rows = slice(b * bs, (b + 1) * bs)
            crop_gap = max(crop_gap, float((rec["irises"] - ref_crops[rows]).abs().max()))
            irises = rec["irises"].permute(0, 3, 1, 2).float()
            r1, r2 = ref_vgg.classifiers(self.vgg, self.c1, self.c2, irises)
            pre_gap = max(pre_gap, rel_gap(rec["p1"], r1), rel_gap(rec["p2"], r2))
            if b == self.sampled:
                style = q16[donor[rows]].expand(-1, -1, -1, 3).permute(0, 3, 1, 2)
                stated = ref_vgg.NSTLoss(self.vgg, irises, style, c["c_loss_weight"], c["s_loss_weight"],
                                         BF16 if c["compute_dtype"] == "bfloat16" else F32)
                nst = nst_gaps(stated, irises, out["nst"], rec["stylized"])
            new = ref_image.composite(frames[rows], rec["stylized"], masks[rows], boxes[rows])
            comp_gap = max(comp_gap, float((rec["new_frames"] - new).abs().max()))
            again = ref_image.crop(rec["new_frames"].float() * masks[rows, ..., None], boxes[rows])
            r1, r2 = ref_vgg.classifiers(self.vgg, self.c1, self.c2, again.expand(-1, -1, -1, 3).permute(0, 3, 1, 2))
            post_gap = max(post_gap, rel_gap(rec["q1"], r1), rel_gap(rec["q2"], r2))
            for i in range(0, bs, 16):
                logits = ref_ritnet.segment_logits(rit, rec["new_frames"][i:i + 16])
                mask_gap = max(mask_gap, label_gap_of(logits, rec["labels"][i:i + 16]))
            want = iou(rec["labels"], inp["labels"][rows].long())
            box_miss += float(((rec["iou"].float() - want).abs() > 1e-6).any(0).sum())
        return {"seg_logit_gap": mask_gap, "derived_mismatch": box_miss, "crop_gap": crop_gap, "pre_logit_gap": pre_gap,
                **nst, "composite_gap": comp_gap, "post_logit_gap": post_gap, "mask_flip_px": flips, "box_flips": box_flips}
