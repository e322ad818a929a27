"""The 2020 IST main's sweep (``workloads/ist_openeds2020.py``), driven as
one pass over a twin of K batches of host frames with gaze labels.

Set-up makes the seeded weights on the card (VGG19; the B7 U-Net, its
head's bias centring each class's mean logit on the warm-up frames so
that the labels hold every class, as the port's own B7 check does; both
estimators), makes the one style iris with the port's
``make_style_iris``, warms every shape with a short NST, times two short
passes to size K to ``--seconds``, and makes the pass's frames.  The
measured pass is one call of ``iris_style_transfer_openeds2020`` with
``programs=`` the port's ``make_programs``, wrapped by a recorder that
keeps what each program returns and times it in CUDA events, and with
``taps.StepTap`` keeping what the NST of one sampled batch hands its
L-BFGS, and ``taps.ApplyTap`` the B7 labels and ResNet50 features the
programs compute inside.
The check judges, against the reference, the style iris and the outputs
of ``JUDGED`` batches drawn from the seed (the NST's sample among them): its
B7 work in float32 would otherwise outlast the window.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark import twin, weights
from benchmark.checks import angle_gap_deg, label_gap_of, nst_gaps, rel_gap
from benchmark.reference import b7 as ref_b7
from benchmark.reference import gaze as ref_gaze
from benchmark.reference import image as ref_image
from benchmark.reference import lbfgs as ref_lbfgs
from benchmark.reference import resnet as ref_resnet
from benchmark.reference import vgg as ref_vgg
from benchmark.reference.precision import BF16, F32, Precision, exact_f32
from benchmark.sweep import Recorder, SweepEntry
from benchmark.taps import ApplyTap, as_step
from benchmark.work import b7 as work_b7
from benchmark.work import conv1 as work_conv1
from benchmark.work import relu_pool as work_relu_pool
from benchmark.work import resnet50 as work_resnet
from benchmark.work import vgg19 as work_vgg

PREFIX = "validation/"
WARM_STREAM = 1_000_000  # twin batches of the warm-up, apart from the pass's 0 .. K-1
STYLE_STREAM = 2_000_000
JUDGED = 3  # batches the check judges
DEGREE_TOL = 1e-3  # the main's float32 host arithmetic of a mean angle, against float64
KERNELS = ("relu_pool_fwd_kernel", "relu_pool_bwd_kernel", "conv1_mma_kernel", "dw_conv_bn_silu_kernel")


class Programs(Recorder):
    """The 2020 main's two programs (pre, post), and B7's labels and
    ResNet50's features in each."""

    def __init__(self, programs, device):
        super().__init__(device)
        self.fns = programs
        self.seg = ApplyTap("iris_style_transfer_tpu_torch.workloads.ist_openeds2020", "EfficientNet", self)
        self.feat = ApplyTap("iris_style_transfer_tpu_torch.models.gaze", "ResNet50", self)

    def pre(self, *args):
        self.next_batch()
        out = self.timed(self.fns[0], *args)
        if self.keeping:
            p1, p2, irises, masks, bboxes, _ = out
            self.batches[self.index] = {"p1": p1, "p2": p2, "irises": irises, "masks": masks[..., 0],
                                        "boxes": bboxes, "labels": self.seg.take(), "feats": self.feat.take()}
        return out

    def post(self, eff, g1, g2, frames, stylized, masks, bboxes):
        out = self.timed(self.fns[1], eff, g1, g2, frames, stylized, masks, bboxes)
        if self.keeping:
            self.batches[self.index].update(stylized=stylized, new_frames=out[0], q1=out[1], q2=out[2],
                                            post_labels=self.seg.take(), post_feats=self.feat.take())
        return out

    def programs(self):
        return self.pre, self.post


class Entry(SweepEntry):
    main = "iris_style_transfer_tpu_torch.workloads.ist_openeds2020"

    # ------------------------------------------------------------------ set-up
    def _frames(self, batches: list[int]) -> tuple[torch.Tensor, torch.Tensor]:
        parts = [twin.eyes(self.seed, b, self.bs, 8, *self.hw, gaze=True, device=self.device) for b in batches]
        return torch.cat([p["frames"] for p in parts]), torch.cat([p["gaze"] for p in parts])

    def _sweep(self, data: tuple[np.ndarray, np.ndarray], closures: int) -> dict:
        from iris_style_transfer_tpu_torch.workloads.ist_openeds2020 import iris_style_transfer_openeds2020

        frames, labels = data
        return iris_style_transfer_openeds2020(
            self.cfg, frames, labels, self.b7, self.g1, self.g2, self.vgg, self.s_iris,
            self.cfg_json["c_loss_weight"], self.cfg_json["s_loss_weight"], closures, PREFIX, self.tmp,
            self.logs, self.device, programs=self.rec.programs(),
        )

    def setup(self) -> None:
        from iris_style_transfer_tpu_torch.models import EfficientNet
        from iris_style_transfer_tpu_torch.workloads.ist_openeds2020 import make_programs, make_style_iris

        c = self.cfg_json
        dtype = self._begin()
        self.vgg = weights.vgg19(self.seed, self.device)
        g1, g2h = weights.mlp_heads(self.seed, [(19, 64, 64, 3), (2048, 64, 64, 3)], self.device)
        self.g1, self.g2 = g1, {"head": g2h, "resnet": weights.resnet50(self.seed, self.device)}
        warm_u8, warm_gaze = self._frames([WARM_STREAM])
        self.b7 = weights.b7(self.seed, self.device)
        with torch.no_grad(), exact_f32():  # centre each class's mean logit on four warm-up frames
            self.b7["head"]["b"] -= ref_b7.segment_logits(self.b7, warm_u8[:4].float() / 255.0).mean((0, 2, 3))
        style = twin.eyes(self.seed, STYLE_STREAM, 1, 8, *self.hw, gaze=True, device=self.device)["frames"]
        self.style_frame = style[0].float() / 255.0
        self.s_iris = make_style_iris(self.b7, self.style_frame, c["glint_threshold"], dtype)
        with torch.no_grad():  # the labels make_style_iris cut the iris by, for the check
            self.style_labels = EfficientNet.apply(self.b7, self.style_frame[None], compute_dtype=dtype)[0]
        self.rec = Programs(make_programs(c["glint_threshold"], dtype, self.device), self.device)
        self.warm = (warm_u8.cpu().numpy(), warm_gaze.cpu().numpy())
        self.batches = self._size(self.warm)
        frames, gaze = self._frames(list(range(self.batches)))
        self.inputs = {"frames": frames, "gaze": gaze}
        self.host = (frames.cpu().numpy(), gaze.cpu().numpy())

    # ------------------------------------------------------------ the window
    def timed_pass(self) -> dict:
        wall, log = self._pass(self.host, JUDGED)
        return self._timed(wall, log[f"{PREFIX}/stylized_images_per_min"] / 60.0 / self.bs)

    def traced_slice(self):
        from benchmark import trace

        prof, wall, _ = trace.traced(lambda: self._sweep(self.warm, self.closures),
                                     trace.has_kernels(KERNELS), "one batch of the 2020 sweep")
        return trace.summarize(prof, wall)

    # ------------------------------------------------------------ the work
    def work(self) -> dict:
        """Per batch: the model FLOPs, and each hand-written kernel's
        launches and bound in seconds."""
        b, n = self.bs, self.closures
        h, w = self.hw
        chunk = self.cfg_json["seg_chunk"]
        b7 = 2 * 2 * b * work_b7.logits_flops_per_frame(h + 16, w)  # pre and post, each with its flip
        resnet = 2 * b * work_resnet.flops_per_frame(h, w)
        nst = 2 * work_vgg.nst_forward_flops(b) + n * work_vgg.nst_closure_flops(b)
        calls = 2 * 2 * math.ceil(b / chunk)  # B7 logits passes a batch, each over one chunk
        dw = work_b7.depthwise_bound_s(chunk, h + 16, w)
        dw_launches = calls * len(work_b7.depthwise_calls(h + 16, w))
        return {
            "flops": b7 + resnet + nst,
            "kernels": {
                "relu_pool_fwd_kernel": (n + 2, work_relu_pool.fwd_bound_s(b, 64, 224, 224)),
                "relu_pool_bwd_kernel": (n, work_relu_pool.bwd_bound_s(b, 64, 224, 224)),
                "conv1_mma_kernel": (n + 2, work_conv1.bound_s(b, 3, 64, 224, 224)),
                "dw_conv_bn_silu_kernel": (dw_launches, dw * calls / dw_launches),
            },
        }

    # ------------------------------------------------------------ the check
    def release(self) -> None:
        """Drop the program's state that the check does not read."""
        self.rec.seg.close()
        self.rec.feat.close()
        self._end()
        self.warm = self.host = None

    def outputs(self) -> dict:
        """What the program produced: the style iris and the labels it was
        cut by; per batch the recorder's outputs and the angular distances
        the main logged; for the sampled batch, what its NST handed the
        L-BFGS at the kept closures."""
        distances = {b: {k: v for k, v in self.logs.records[b].items() if "degree_distance" in k}
                     for b in self.rec.batches}
        return {"s_iris": self.s_iris, "style_labels": self.style_labels, "batches": self.rec.batches,
                "distances": distances,
                "nst": {k: as_step(r) for k, r in self.tap.records.items()}}

    def _estimates(self, frames: torch.Tensor, prec: Precision, labels=None, feats=None):
        """The reference's segmentation logits, ResNet50 features and both
        estimators' gaze; the estimators read ``labels`` and ``feats`` (the
        program's, being judged) where given, else the reference's own."""
        logits = ref_b7.segment_logits(self.b7, frames, prec)
        p1 = ref_gaze.mlp(self.g1, ref_gaze.landmarks(logits.argmax(1) if labels is None else labels), prec)
        ref_feats = torch.cat([ref_resnet.features(self.g2["resnet"], frames[i:i + 16].expand(-1, -1, -1, 3), prec)
                               for i in range(0, frames.shape[0], 16)])
        p2 = ref_gaze.mlp(self.g2["head"], ref_feats if feats is None else feats, prec)
        return logits, ref_feats, p1, p2

    def _style_iris(self, labels: torch.Tensor, prec: Precision) -> torch.Tensor:
        """The style frame's iris under ``labels``, cut and resized."""
        fr = self.style_frame[None]
        m = ref_image.iris_mask(labels[None], fr, self.cfg_json["glint_threshold"])
        return ref_image.crop(fr * m[..., None], ref_image.bbox(m), prec=prec)[0]

    def _distances(self, rec: dict, b: int) -> dict[str, float]:
        """Each phase's and estimator's mean angle in degrees between the
        batch's gaze and the labels, keyed as the main logs it."""
        labs = self.inputs["gaze"][b * self.bs:(b + 1) * self.bs].double()
        out = {}
        for phase, pair in (("pre", ("p1", "p2")), ("post", ("q1", "q2"))):
            for i, key in zip("12", pair):
                cos = (rec[key].double() * labs).sum(1).clamp(-1.0, 1.0)
                out[f"{PREFIX}/batch/{phase}/degree_distance{i}"] = float(torch.rad2deg(torch.arccos(cos)).mean())
        return out

    def control_outputs(self, prec: Precision) -> dict:
        """The reference at ``prec`` in the program's place, on the pass's
        inputs, as :meth:`outputs` gives them."""
        c, bs = self.cfg_json, self.bs
        with exact_f32(), torch.no_grad():
            style_labels = ref_b7.segment_logits(self.b7, self.style_frame[None], prec).argmax(1)[0]
            s_iris = self._style_iris(style_labels, prec)
            style = s_iris.expand(bs, -1, -1, 3).permute(0, 3, 1, 2)
            frames_all = self.inputs["frames"].float() / 255.0
            batches, steps = {}, {}
            for b in sorted(self.rec.judged):
                frames = frames_all[b * bs:(b + 1) * bs]
                logits, feats, p1, p2 = self._estimates(frames, prec)
                labels = logits.argmax(1)
                masks = ref_image.iris_mask(labels, frames, c["glint_threshold"])
                boxes = ref_image.bbox(masks)
                irises = ref_image.crop(frames * masks[..., None], boxes, prec=prec).expand(-1, -1, -1, 3)
                x0 = irises.permute(0, 3, 1, 2)
                stylized = x0
                if b == self.sampled:
                    loss = ref_vgg.NSTLoss(self.vgg, x0, style, c["c_loss_weight"], c["s_loss_weight"], prec)
                    stylized, _, rec = ref_lbfgs.lbfgs_nst(loss, x0, self.closures, c["lbfgs_history"], prec=prec,
                                                           record=(0, 1, self.closures - 1))
                    steps = {k: dict(r, lr=1.0, first=k == 0) for k, r in rec.items()}
                new = ref_image.composite(frames, stylized, masks, boxes, prec)
                post_logits, post_feats, q1, q2 = self._estimates(new, prec)
                batches[b] = {"p1": p1, "p2": p2, "irises": irises, "masks": masks, "boxes": boxes, "labels": labels,
                              "feats": feats, "stylized": stylized, "new_frames": new, "q1": q1, "q2": q2,
                              "post_labels": post_logits.argmax(1), "post_feats": post_feats}
        distances = {b: self._distances(rec, b) for b, rec in batches.items()}
        return {"s_iris": s_iris, "style_labels": style_labels, "batches": batches, "distances": distances,
                "nst": steps}

    def judge(self, out: dict | None = None) -> dict[str, float]:
        """The check's readings of ``out`` (the program's outputs when None)."""
        with exact_f32(), torch.no_grad():
            return self._judge(self.outputs() if out is None else out)

    def _judge(self, out: dict) -> dict[str, float]:
        c, bs, f32 = self.cfg_json, self.bs, F32
        fr = self.style_frame[None]
        label_gap = label_gap_of(ref_b7.segment_logits(self.b7, fr), out["style_labels"][None])
        ref_style = self._style_iris(out["style_labels"], f32)
        crop_gap = float((out["s_iris"].float() - ref_style).abs().max())
        derived = comp_gap = 0.0
        pre1 = pre2 = post1 = post2 = feat_gap = 0.0
        style = ref_style.expand(bs, -1, -1, 3).permute(0, 3, 1, 2)
        frames_all = self.inputs["frames"].float() / 255.0
        for b, rec in sorted(out["batches"].items()):
            frames = frames_all[b * bs:(b + 1) * bs]
            masks, boxes, labels = rec["masks"].bool(), rec["boxes"].long(), rec["labels"]
            logits, feats, p1, p2 = self._estimates(frames, f32, labels, rec["feats"])
            feat_gap = max(feat_gap, rel_gap(rec["feats"], feats))
            label_gap = max(label_gap, label_gap_of(logits, labels))
            want = ref_image.iris_mask(labels, frames, c["glint_threshold"])
            derived += float(((want != masks).flatten(1).any(1) | (ref_image.bbox(masks) != boxes).any(1)).sum())
            logged = out["distances"][b]
            derived += sum(abs(logged.get(k, float("nan")) - v) > DEGREE_TOL or k not in logged
                           for k, v in self._distances(rec, b).items())
            crop = ref_image.crop(frames * masks[..., None], boxes)
            crop_gap = max(crop_gap, float((rec["irises"].float() - crop).abs().max()))
            pre1, pre2 = max(pre1, angle_gap_deg(rec["p1"], p1)), max(pre2, angle_gap_deg(rec["p2"], p2))
            new = ref_image.composite(frames, rec["stylized"], masks, boxes)
            comp_gap = max(comp_gap, float((rec["new_frames"].float() - new).abs().max()))
            post_logits, feats, q1, q2 = self._estimates(rec["new_frames"].float(), f32, rec["post_labels"],
                                                         rec["post_feats"])
            feat_gap = max(feat_gap, rel_gap(rec["post_feats"], feats))
            label_gap = max(label_gap, label_gap_of(post_logits, rec["post_labels"]))
            post1, post2 = max(post1, angle_gap_deg(rec["q1"], q1)), max(post2, angle_gap_deg(rec["q2"], q2))
            if b == self.sampled:
                x0 = rec["irises"].permute(0, 3, 1, 2).float()
                stated = ref_vgg.NSTLoss(self.vgg, x0, style, c["c_loss_weight"], c["s_loss_weight"],
                                         BF16 if c["compute_dtype"] == "bfloat16" else F32)
                nst = nst_gaps(stated, x0, out["nst"], rec["stylized"])
        return {"seg_logit_gap": label_gap, "derived_mismatch": derived, "crop_gap": crop_gap,
                "pre_gaze1_gap_deg": pre1, "pre_gaze2_gap_deg": pre2, "resnet_feature_gap": feat_gap,
                **nst, "composite_gap": comp_gap, "post_gaze1_gap_deg": post1, "post_gaze2_gap_deg": post2}
