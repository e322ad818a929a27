"""B7's training as the port's gaze tool runs it (stage 0), at chosen
training seeds, with one of three backwards of the fused depthwise op
(``ops/depthwise.py``), and the rounding-level control those runs are read
against.

The arms:

* ``kernels``: the op's backward as it runs on the card (three kernels);
* ``plain``: :func:`dw_conv_bn_silu_bwd`, the plain f32 backward, in the
  kernels' place;
* ``reversed``: the plain backward on x, w and the cotangent flipped in H
  and W, its dx and dw flipped back (:func:`reversed_bwd`): the same
  function, each k x k tap sum taken in the reverse order and the B*H*W
  reductions in another, so a change at the level of rounding and no
  other.

The B7 gate's outcome at a seed (eval mIoU >= 0.95, ``RESULTS.md``) is read
against the control: if ``reversed`` moves the outcomes of ``plain`` about
as often as ``kernels`` does, the kernels' rounding is no worse than any
other order of the same sums.

On a GPU, from the repository's root::

    PYTHONPATH=. python tests/test_torch_b7_sweep.py --seeds 13 14 15 --arms kernels plain reversed
    PYTHONPATH=. python tests/test_torch_b7_sweep.py --seeds 13 --first_outside

The data and the recipe are the gaze tool's at its defaults (its
``parser()``): the twin, 160 training frames and 32 held out, 6 epochs at
bs 2, Adam, bf16 activations; ``--seeds`` are ``train_efficientnet``'s
(the init and the shuffle; the tool's is 13).  One JSON line per (seed,
arm): seconds, the held-out mIoU, the final loss, the steps whose loss
passed 2 and the largest loss with its step.

``--first_outside`` trains with the kernels, holds every call against the
plain backward (``grad_within_tolerance``) and at the first call outside
the bound prints one JSON line about it and stops: its shape, k, dtype
and step, the errors and scales, dx's equal share, the share of the
mismatched dx elements where each form equals the float64 result rounded
to x's dtype, the ``reversed`` control's equal share against the plain
backward on the same inputs, both forms' equal share under the cotangent
scaled by 2^24 (exact in binary), and the cancellation ratio (the sum of
the magnitudes of dx's k*k terms over |dx|) at the mismatched elements
and overall.

The tests below run on the CPU: the control and the float64 dx agree
with the plain backward within the kernels' bound, and the control is
not bit-equal to it.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from iris_style_transfer_tpu_torch.models.efficientnet import depthwise_shapes
from iris_style_transfer_tpu_torch.ops import depthwise as dw


def _flip(t: torch.Tensor | None) -> torch.Tensor | None:
    return None if t is None else t.flip(2, 3)


def reversed_bwd(x, w, a, b, k, gy, needs=(True,) * 4) -> tuple:
    """:func:`dw_conv_bn_silu_bwd` on x, w and gy flipped in H and W, its
    dx and dw flipped back: the same gradient, summed in another order."""
    dx, dw_, da, db = dw.dw_conv_bn_silu_bwd(_flip(x), _flip(w), a, b, k, _flip(gy), needs)
    return _flip(dx), _flip(dw_), da, db


def dx_f64(x, w, a, b, k, gy) -> tuple[torch.Tensor, torch.Tensor]:
    """dx of the op in float64 (w rounded to x's dtype, as the forward
    rounds it) and the sum of the magnitudes of its k*k terms, NCHW."""
    c, p = x.shape[1], (k - 1) // 2
    wk = w.to(x.dtype).double()
    a64, b64 = a.double()[:, None, None], b.double()[:, None, None]
    z = F.conv2d(x.double(), wk, padding=p, groups=c) * a64 + b64
    sig = torch.sigmoid(z)
    dacc = gy.double() * sig * (1 + z * (1 - sig)) * a64
    wf = wk.flip(2, 3)
    return F.conv2d(dacc, wf, padding=p, groups=c), F.conv2d(dacc.abs(), wf.abs(), padding=p, groups=c)


def _inputs(shape, k, dtype, seed, gy_max=None):
    gen = torch.Generator().manual_seed(seed)
    bsz, c, h, wd = shape
    x = torch.randn(shape, generator=gen).to(dtype).contiguous(memory_format=torch.channels_last)
    w = torch.randn((c, 1, k, k), generator=gen) * 0.2
    a = torch.rand(c, generator=gen) * 1.5 + 0.5
    b = torch.randn(c, generator=gen)
    gy = torch.randn(shape, generator=gen)
    if gy_max is not None:
        gy = gy / gy.abs().max() * gy_max
    return x, w, a, b, gy.to(dtype).contiguous(memory_format=torch.channels_last)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,k", [((2, 24, 20, 32), 3), ((2, 13, 9, 36), 5)])
def test_reversed_control_is_a_rounding_perturbation_of_the_plain_backward(shape, k, dtype):
    x, w, a, b, gy = _inputs(shape, k, dtype, seed=k)
    want = dw.dw_conv_bn_silu_bwd(x, w, a, b, k, gy)
    got = reversed_bwd(x, w, a, b, k, gy)
    ok, errs = dw.grad_within_tolerance(got, want, dtype)
    assert ok, errs
    assert not all(torch.equal(g, p) for g, p in zip(got, want))
    assert got[0].shape == x.shape and got[1].shape == w.shape


@pytest.mark.parametrize("gy_max", [None, 3e-6])
@pytest.mark.parametrize("shape,k", [((2, 24, 20, 32), 3), ((2, 13, 9, 36), 5)])
def test_float64_dx_matches_the_plain_backward(shape, k, gy_max):
    x, w, a, b, gy = _inputs(shape, k, torch.float32, seed=10 + k, gy_max=gy_max)
    ref, terms = dx_f64(x, w, a, b, k, gy)
    want = dw.dw_conv_bn_silu_bwd(x, w, a, b, k, gy)[0]
    assert (ref.float() - want).abs().max().item() <= 1e-5 * want.abs().max().item()
    assert bool((terms >= ref.abs() * (1 - 1e-12)).all())


class _Outside(Exception):
    """Raised by the checked backward at the first call outside the bound."""


def _equal_share(u: torch.Tensor, v: torch.Tensor) -> float:
    return (u == v).float().mean().item()


def _outside_report(kernels, x, w, a, b, k, gy, got, want, errs) -> dict:
    """What the first call outside the bound shows (the module docstring);
    ``kernels`` is the op's kernel backward."""
    dxk, dxp = got[0].float(), want[0].float()
    ref, terms = dx_f64(x, w, a, b, k, gy)
    ref_r = ref.to(x.dtype).float()
    diff = dxk != dxp
    ratio = terms / ref.abs().clamp_min(1e-300)
    scale = 2.0**24
    gys = (gy.float() * scale).to(gy.dtype)
    dxk_s = kernels(x, w, a, b, k, gys, (True, False, False, False))[0].float()
    dxp_s = dw.dw_conv_bn_silu_bwd(x, w, a, b, k, gys, (True, False, False, False))[0].float()
    return {
        "shape": list(x.shape), "k": k, "dtype": str(x.dtype).replace("torch.", ""),
        "errs": errs, "scales": [p.float().abs().max().item() if p is not None else 0.0 for p in want],
        "within_ulp_and_share": list(dw.within_tolerance(got[0], want[0])),
        "gy_max": gy.float().abs().max().item(),
        "dx_equal_share": _equal_share(dxk, dxp), "mismatches": int(diff.sum()),
        "kernel_equals_f64_at_mismatches": _equal_share(dxk[diff], ref_r[diff]) if diff.any() else None,
        "plain_equals_f64_at_mismatches": _equal_share(dxp[diff], ref_r[diff]) if diff.any() else None,
        "kernel_equals_f64": _equal_share(dxk, ref_r), "plain_equals_f64": _equal_share(dxp, ref_r),
        "reversed_vs_plain_equal_share": _equal_share(reversed_bwd(x, w, a, b, k, gy)[0].float(), dxp),
        "scaled_2e24_equal_share": _equal_share(dxk_s, dxp_s),
        "scaled_2e24_exact": bool(torch.equal(dxk_s, dxk * scale) and torch.equal(dxp_s, dxp * scale)),
        "cancellation_median_mismatches": ratio[diff].median().item() if diff.any() else None,
        "cancellation_median_all": ratio.median().item(),
        "cancellation_share_over_100": (ratio > 100).float().mean().item(),
    }


def _arm(name: str, state: dict):
    """The backward that stands in the kernels' place for an arm."""
    kernels = dw._kernel_bwd
    if name == "kernels":
        return kernels
    if name == "plain":
        return dw.dw_conv_bn_silu_bwd
    if name == "reversed":
        return reversed_bwd

    def checked(x, w, a, b, k, gy, needs=(True,) * 4):
        got = kernels(x, w, a, b, k, gy, needs)
        want = dw.dw_conv_bn_silu_bwd(x, w, a, b, k, gy, needs)
        ok, errs = dw.grad_within_tolerance(got, want, x.dtype)
        state["calls"] += 1
        if not ok:
            state["report"] = _outside_report(kernels, x, w, a, b, k, gy, got, want, errs)
            raise _Outside
        return got

    return checked


def main(argv: list[str] | None = None) -> None:
    from iris_style_transfer_tpu_torch.data import synthetic_eye_batch
    from iris_style_transfer_tpu_torch.ops.metrics import iou_per_class
    from iris_style_transfer_tpu_torch.tools import replicate_synthetic_gaze as gaze

    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="+", default=[13])
    ap.add_argument("--arms", nargs="+", choices=("kernels", "plain", "reversed"), default=["kernels"])
    ap.add_argument("--first_outside", action="store_true",
                    help="train with the kernels checked; report the first call outside the bound")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("test_torch_b7_sweep: needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=False).stdout.strip().splitlines()
    print(card[0] if card else "nvidia-smi: no reading", flush=True)

    tool = gaze.parser().parse_args([])
    imgs, segs, _, _ = synthetic_eye_batch(tool.n_train + tool.n_eval, seed=tool.seed, gaze=True)
    frames = torch.from_numpy(imgs[tool.n_train:]).cuda()
    held_out = torch.from_numpy(segs[tool.n_train:]).cuda()
    kernels = dw._kernel_bwd
    arms = ["checked"] if args.first_outside else args.arms
    try:
        for seed in args.seeds:
            for arm in arms:
                state = {"calls": 0}
                dw._kernel_bwd = _arm(arm, state)
                t0 = time.perf_counter()
                try:
                    params, losses = gaze.train_efficientnet(imgs[:tool.n_train], segs[:tool.n_train],
                                                             epochs=tool.effnet_epochs, seed=seed, device="cuda")
                except _Outside:
                    print(json.dumps({"seed": seed, "call": state["calls"],
                                      "step": (state["calls"] - 1) // sum(depthwise_shapes().values()), **state["report"]}), flush=True)
                    continue
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
                _, miou = iou_per_class(gaze._seg_apply_chunked(params, frames), held_out)
                loss = losses.float().cpu().numpy()
                print(json.dumps({
                    "seed": seed, "arm": arm, "seconds": seconds, "eval_miou": float(np.nanmean(miou.cpu().numpy())),
                    "final_loss": float(loss[-1]), "steps_over_2": int((loss > 2).sum()),
                    "max_loss": float(loss.max()), "max_step": int(loss.argmax()),
                    "calls_checked": state["calls"]}), flush=True)
    finally:
        dw._kernel_bwd = kernels


if __name__ == "__main__":
    main()
