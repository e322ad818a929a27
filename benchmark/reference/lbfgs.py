"""The NST's optimizer: ``torch.optim.LBFGS(lr=1)`` without line search,
one update after each closure evaluation, x clamped to [0, 1] at each
closure's start; the first step ``t = min(1, 1/|g|_1) * lr``, later ones
``lr``; a pair kept only when ``y.s > 1e-10``; the initial Hessian scale
``y.s / y.y`` of the newest pair; at most ``history`` pairs.  The direction
is the textbook two-loop recursion (Nocedal and Wright, algorithm 7.4).
"""

from __future__ import annotations

import torch

from .precision import F32, Precision


def two_loop(pairs: list[tuple[torch.Tensor, torch.Tensor]], rhos: list[float], gamma: float, g: torch.Tensor,
             rnd=lambda t: t) -> torch.Tensor:
    """-H g from the pairs (oldest first) with their 1/(y.s), in float64;
    ``rnd`` rounds the running vector after each step (the control's)."""
    q = rnd(-g.double())
    alphas = []
    for (s, y), rho in zip(reversed(pairs), reversed(rhos)):
        a = rho * float((s.double() * q).sum())
        alphas.append(a)
        q = rnd(q - a * y.double())
    q = rnd(q * gamma)
    for (s, y), rho, a in zip(pairs, rhos, reversed(alphas)):
        b = rho * float((y.double() * q).sum())
        q = rnd(q + s.double() * (a - b))
    return q.float()


def lbfgs_nst(loss, x0: torch.Tensor, closures: int, history: int = 10, lr: float = 1.0,
              prec: Precision = F32, record=()) -> tuple[torch.Tensor, torch.Tensor, dict]:
    """``closures`` closure evaluations of ``loss`` (a callable returning
    (total, content, style)), each followed by one update.  Returns (x
    clamped to [0, 1], the (closures, 3) history of the losses at each
    closure's x, and for each closure in ``record`` its x, gradient, update,
    and the pairs, 1/(y.s) and scale the update was computed from).  The
    control (``prec`` lower) keeps its pairs rounded by ``prec.low`` and
    rounds its running vector likewise."""
    rnd = prec.low
    x = x0.detach().clone()
    pairs: list[tuple[torch.Tensor, torch.Tensor]] = []
    rhos: list[float] = []
    gamma = 1.0
    hist = torch.zeros(closures, 3, device=x.device)
    records = {}
    prev_g = step = None
    for k in range(closures):
        with torch.enable_grad():
            x = x.clamp(0.0, 1.0).requires_grad_(True)
            total, c, s = loss(x)
            (g,) = torch.autograd.grad(total, x)
        x = x.detach()
        hist[k] = torch.stack([total.detach(), torch.as_tensor(c).detach(), torch.as_tensor(s).detach()])
        if k == 0:
            update = rnd(-g * min(1.0, 1.0 / float(g.abs().sum())) * lr)
        else:
            y = g - prev_g
            ys = float((y * step).sum())
            if ys > 1e-10:
                pairs.append((rnd(step), rnd(y)))
                rhos.append(1.0 / ys)
                gamma = ys / float((y * y).sum())
                if len(pairs) > history:
                    pairs.pop(0)
                    rhos.pop(0)
            update = two_loop(pairs, rhos, gamma, g, rnd) * lr
        if k in record:
            records[k] = {"x": x, "g": g, "update": update, "pairs": list(pairs), "rhos": list(rhos),
                          "gamma": gamma}
        prev_g, step = g, update
        x = x + update
    return x.clamp(0.0, 1.0), hist, records
