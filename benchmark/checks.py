"""The check's ways of measuring a gap between an output of the program
and the reference."""

from __future__ import annotations

import torch

from benchmark.reference import lbfgs as ref_lbfgs

STRAY = 1e9  # the seg gap of an iris pixel above the glint threshold


def unpack_bits(packed: torch.Tensor) -> torch.Tensor:
    """(N, H, W/8, 1) uint8, LSB first along W -> (N, H, W) bool."""
    p = packed[..., 0]
    bits = (p[..., None] >> torch.arange(8, device=p.device, dtype=torch.uint8)) & 1
    return bits.reshape(*p.shape[:-1], p.shape[-1] * 8).bool()


def l2_gap(a: torch.Tensor, ref: torch.Tensor) -> float:
    if a.shape != ref.shape:
        return float("inf")
    return float((a.double() - ref.double()).norm() / ref.double().norm().clamp_min(1e-300))


def cos_gap(a: torch.Tensor, ref: torch.Tensor) -> float:
    if a.shape != ref.shape:
        return float("inf")
    a, ref = a.double().flatten(), ref.double().flatten()
    return float(1.0 - (a @ ref) / (a.norm() * ref.norm()).clamp_min(1e-300))


def rel_gap(a: torch.Tensor, ref: torch.Tensor) -> float:
    """The largest difference over the reference's largest magnitude."""
    if a.shape != ref.shape:
        return float("inf")
    return float((a.float() - ref.float()).abs().max() / ref.float().abs().max().clamp_min(1e-30))


def angle_gap_deg(a: torch.Tensor, ref: torch.Tensor) -> float:
    """The largest angle in degrees between matching rows of unit vectors."""
    if a.shape != ref.shape:
        return float("inf")
    cos = (a.double() * ref.double()).sum(1) / (a.double().norm(dim=1) * ref.double().norm(dim=1))
    return float(torch.rad2deg(torch.arccos(cos.clamp(-1.0, 1.0))).max())


def seg_gap(logits: torch.Tensor, masks: torch.Tensor, gate: torch.Tensor, iris: int = 2) -> float:
    """How far the program's iris masks stray from the reference's logits:
    at a pixel the program calls iris, the best logit's lead over the iris
    logit; at one it does not (and the glint gate lets through), the iris
    logit's lead over the best other; :data:`STRAY` for an iris pixel the
    gate shuts."""
    other = torch.cat([logits[:, :iris], logits[:, iris + 1:]], 1).amax(1)
    gap_in = torch.where(masks, logits.amax(1) - logits[:, iris], 0.0)
    gap_out = torch.where(~masks & gate, (logits[:, iris] - other).clamp_min(0), 0.0)
    stray = STRAY if bool((masks & ~gate).any()) else 0.0
    return max(float(torch.maximum(gap_in, gap_out).max()), stray)


def label_gap_of(logits: torch.Tensor, labels: torch.Tensor) -> float:
    """The widest gap by which the logit of the program's label lies below
    the reference's best, over every pixel: (B, C, H, W) logits, (B, H, W)
    labels."""
    return float((logits.amax(1) - logits.gather(1, labels.long()[:, None])[:, 0]).max())


def iou(seg: torch.Tensor, gt: torch.Tensor, classes: int = 4) -> torch.Tensor:
    """(classes, B) per-class IoU of (B, H, W) label maps."""
    inter = torch.stack([((seg == k) & (gt == k)).sum((1, 2)) for k in range(classes)]).float()
    union = torch.stack([((seg == k) | (gt == k)).sum((1, 2)) for k in range(classes)]).float()
    return inter / (union + 1e-6)


def nst_gaps(grad_loss, x0: torch.Tensor, steps: dict, stylized: torch.Tensor) -> dict[str, float]:
    """The NST judged at the kept closures 0, 1 and the last.  The
    gradient at each kept x (x_0 the content, later ones the iterate as
    the program's updates move it) against ``grad_loss``'s, the reference
    in the configuration's compute type, as 1 - their cosine:
    ``nst_grad_gap`` at closure 0, ``nst_grad_gap_1`` at closure 1 (the
    first step leaves the crops' zero background at about 1e-7, where
    bf16 ties part), ``nst_last_grad_gap`` at the last, on an iterate that
    the trajectory's noise has moved.  Each kept update against the
    reference's L-BFGS update from the same gradient, pairs and scale, as
    a relative L2 gap: ``lbfgs_first_step_gap`` the first, the scaled
    gradient; ``lbfgs_step_gap`` the largest of the later ones, which the
    program's compact form computes with the gradient and its
    coefficients rounded to the history's bf16 (``_compact_direction``),
    a rounding that grows where the pairs are nearly dependent.  And
    ``nst_image_mismatch``: the images whose iterate left the loop other
    than it should: x_0 not the clamped content, or the output not
    clamp(x + update) of the last closure, so not the iterate that every
    update moved.  A closure that was not kept reads as gaps of 1 and
    every image astray."""
    last = max(steps, default=None)
    if 0 not in steps or last is None:
        return {"nst_grad_gap": 1.0, "nst_grad_gap_1": 1.0, "nst_last_grad_gap": 1.0, "lbfgs_first_step_gap": 1.0,
                "lbfgs_step_gap": 1.0, "nst_image_mismatch": float(x0.shape[0])}
    grads, offs = {}, {}
    for k, st in steps.items():
        with torch.enable_grad():
            x = st["x"].detach().clone().requires_grad_(True)
            (g,) = torch.autograd.grad(grad_loss(x)[0], x)
        grads[k] = cos_gap(st["g"], g)
        g = st["g"]
        if st["first"]:
            want = -g * min(1.0, 1.0 / float(g.abs().sum())) * st["lr"]
        else:
            want = ref_lbfgs.two_loop(st["pairs"], st["rhos"], st["gamma"], g) * st["lr"]
        offs[k] = l2_gap(st["update"], want)
    start = (steps[0]["x"] != x0.float().clamp(0.0, 1.0)).flatten(1).any(1)
    end = (stylized.float() != (steps[last]["x"] + steps[last]["update"]).clamp(0.0, 1.0)).flatten(1).any(1)
    return {"nst_grad_gap": grads[0], "nst_grad_gap_1": grads.get(1, 1.0), "nst_last_grad_gap": grads[last],
            "lbfgs_first_step_gap": offs[0], "lbfgs_step_gap": max([v for k, v in offs.items() if k > 0] or [1.0]),
            "nst_image_mismatch": float((start | end).sum())}
