"""On-device L-BFGS with ``torch.optim.LBFGS``'s default semantics, sync-free.

Counterpart of ``iris_style_transfer_tpu/transfer/lbfgs.py``.  Each
closure evaluation is followed by exactly one update, as torch's
``LBFGS(lr=1)`` without line search does:

  * the first iteration uses ``t = min(1, 1/|g|_1) * lr``, later ones ``lr``;
  * curvature pairs use the unprojected update ``s = t*d``;
  * a pair is accepted only when ``y.s > 1e-10``;
  * the initial Hessian scale is ``gamma = y.s / y.y``.

``torch.optim.LBFGS`` reads Python booleans off the device every step;
this one never does.  Every decision that depends on a device value is a
``torch.where``; the only host-side branch is ``iteration == 0``, which
the host knows.  History is a circular buffer: an accepted pair overwrites
slot ``count % m`` (one in-place ``index_copy_``: a step consumes the
state it is given, which saves copying both (m, N) buffers every closure),
and chronological order is a permutation applied to the (m,) and (m, m)
quantities only.  The buffers
may be bfloat16 (``dtype``); their dot products accumulate in float32.

With a process ``group`` the parameter is split over its ranks (the NST's
image batch, ``parallel/mesh.py``), and every inner product is the sum of
the ranks' partial ones: ``y.s``, ``y.y`` and ``|g|_1`` in one
``all_reduce``, the compact direction's ``S g``, ``Y g``, ``S Y'`` and
``Y Y'`` (2m + 2m^2 floats) in one more.  The (m,) and (m, m) algebra then
runs identically on every rank, and each rank applies it to its own block.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..parallel.mesh import all_reduce


class LBFGSState(NamedTuple):
    s_hist: torch.Tensor  # (m, *shape) previous steps, circular buffer
    y_hist: torch.Tensor  # (m, *shape) previous gradient differences
    rho: torch.Tensor  # (m,) 1/(y.s) per slot; 0 marks a never-written slot
    gamma: torch.Tensor  # () initial Hessian scale
    prev_g: torch.Tensor  # (*shape,) gradient at the previous closure
    prev_step: torch.Tensor  # (*shape,) previous update t*d
    iteration: int  # global iteration counter (host-known)
    count: torch.Tensor  # () accepted pairs; the next write goes to count % m


def lbfgs_init(shape, history_size: int = 10, dtype=torch.float32, device="cpu") -> LBFGSState:
    """State for a parameter of ``shape`` (an int means a flat vector).
    ``dtype`` applies to the (m, *shape) history buffers only."""
    m = history_size
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    f32 = {"dtype": torch.float32, "device": device}
    return LBFGSState(
        s_hist=torch.zeros((m, *shape), dtype=dtype, device=device),
        y_hist=torch.zeros((m, *shape), dtype=dtype, device=device),
        rho=torch.zeros(m, **f32),
        gamma=torch.ones((), **f32),
        prev_g=torch.zeros(shape, **f32),
        prev_step=torch.zeros(shape, **f32),
        iteration=0,
        count=torch.zeros((), dtype=torch.int64, device=device),
    )


def _vdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """float32 full contraction of two parameter-shaped tensors."""
    return (a.float() * b.float()).sum()


def _chron_perm(state: LBFGSState) -> torch.Tensor:
    """Slot indices oldest -> newest: ``(count + i) % m``; never-written
    slots (rho == 0) come first and are masked downstream."""
    m = state.s_hist.shape[0]
    return (state.count + torch.arange(m, device=state.count.device)) % m


def _compact_direction(state: LBFGSState, g: torch.Tensor, group=None) -> torch.Tensor:
    """-H @ g by the compact representation (Byrd-Nocedal-Schnabel; Nocedal
    & Wright eq. 7.25).  All work on (m, N) buffers is six matrix products;
    the chronological permutation and the two triangular solves act on
    (m,) and (m, m) quantities."""
    m = state.s_hist.shape[0]
    gamma = state.gamma
    bufdt = state.s_hist.dtype
    S = state.s_hist.reshape(m, -1).float()
    Y = state.y_hist.reshape(m, -1).float()
    gb = g.reshape(-1).to(bufdt).float()

    Sg = S @ gb
    Yg = Y @ gb
    SY = S @ Y.t()  # (i, j) = s_i . y_j in slot order
    YY = Y @ Y.t()
    if group is not None:
        packed = all_reduce(torch.cat([Sg, Yg, SY.reshape(-1), YY.reshape(-1)]), group)
        Sg, Yg, SY, YY = packed.split([m, m, m * m, m * m])
        SY, YY = SY.view(m, m), YY.view(m, m)

    perm = _chron_perm(state)
    rho_c = state.rho[perm]
    valid = rho_c > 0
    SYc = SY[perm][:, perm]
    YYc = YY[perm][:, perm]
    p = torch.where(valid, Sg[perm], 0.0)
    q = gamma * torch.where(valid, Yg[perm], 0.0)

    # the R/D diagonal is the float32 y.s that acceptance used (1/rho):
    # a bf16 buffer dot of a near-cancelling pair could be zero or negative;
    # never-written slots get 1 so the solves stay well-posed
    D = torch.where(valid, 1.0 / torch.clamp_min(rho_c, 1e-30), 1.0)
    R = torch.triu(SYc, diagonal=1) + torch.diag(D)
    Rinv_p = torch.linalg.solve_triangular(R, p[:, None], upper=True)[:, 0]
    DgYY = torch.diag(D) + gamma * YYc
    rhs = (DgYY @ Rinv_p - q)[:, None]
    top_c = torch.linalg.solve_triangular(R.t(), rhs, upper=False)[:, 0]
    bot_c = -Rinv_p

    # back to slot order: slot j sits at chronological position (j-count)%m
    inv = (torch.arange(m, device=perm.device) - state.count) % m
    top = top_c[inv].to(bufdt).float()
    bot = bot_c[inv].to(bufdt).float()
    St = (top @ S).reshape(g.shape)
    Yb = (bot @ Y).reshape(g.shape)
    return -(gamma * g + St + gamma * Yb)


def _two_loop(state: LBFGSState, g: torch.Tensor) -> torch.Tensor:
    """Two-loop recursion for -H @ g (the textbook form; a test oracle, on
    one rank only)."""
    m = state.s_hist.shape[0]
    perm = _chron_perm(state)
    q = g
    alphas = torch.zeros(m, dtype=torch.float32, device=g.device)
    for i in range(m):
        idx = perm[m - 1 - i]  # most recent first
        valid = state.rho[idx] > 0
        alpha = torch.where(valid, state.rho[idx] * _vdot(state.s_hist[idx], q), 0.0)
        q = q - alpha * state.y_hist[idx].float()
        alphas = alphas.index_copy(0, idx.reshape(1), alpha.reshape(1))
    r = state.gamma * q
    for i in range(m):
        idx = perm[i]  # oldest first
        valid = state.rho[idx] > 0
        beta = state.rho[idx] * _vdot(state.y_hist[idx], r)
        upd = state.s_hist[idx].float() * (alphas[idx] - beta)
        r = r + torch.where(valid, upd, 0.0)
    return -r


def lbfgs_step(
    state: LBFGSState, g: torch.Tensor, lr: float = 1.0, method: str = "compact", group=None
) -> tuple[torch.Tensor, LBFGSState]:
    """One L-BFGS iteration given the gradient at the current point.
    Returns ``(update, new_state)``; the caller adds ``update`` (= t*d).
    With ``group``, ``g`` and the state are this rank's block of a
    parameter split over the group's ranks."""
    if group is not None and method != "compact":
        raise ValueError("the two-loop recursion is a one-rank test oracle; a split parameter takes 'compact'")
    m = state.s_hist.shape[0]
    g = g.float()
    first = state.iteration == 0

    y = g - state.prev_g
    s = state.prev_step
    ys = _vdot(y, s)
    yy = _vdot(y, y)
    g1 = g.abs().sum() if first else None
    if group is not None:
        ys, yy, g1 = _global_dots(group, ys, yy, g1)
    accept = (ys > 1e-10) & (not first)

    # circular-buffer write: the new pair on accept, the old row back on reject
    w = (state.count % m).reshape(1)

    def push(buf, v):
        row = torch.where(accept, v.to(buf.dtype), buf.index_select(0, w)[0])
        return buf.index_copy_(0, w, row[None])

    s_hist = push(state.s_hist, s)
    y_hist = push(state.y_hist, y)
    new_rho = torch.where(accept, 1.0 / torch.clamp_min(ys, 1e-30), state.rho.index_select(0, w)[0])
    rho = state.rho.index_copy(0, w, new_rho.reshape(1))
    gamma = torch.where(accept, ys / torch.clamp_min(yy, 1e-30), state.gamma)
    count = state.count + accept.to(state.count.dtype)

    if first:
        d = -g
        t = torch.clamp_max(1.0 / torch.clamp_min(g1, 1e-30), 1.0) * lr
    else:
        tmp = LBFGSState(s_hist, y_hist, rho, gamma, g, s, state.iteration, count)
        d = _compact_direction(tmp, g, group) if method == "compact" else _two_loop(tmp, g)
        t = lr
    update = t * d
    return update, LBFGSState(s_hist, y_hist, rho, gamma, g, update, state.iteration + 1, count)


def _global_dots(group, ys: torch.Tensor, yy: torch.Tensor, g1: torch.Tensor | None):
    """``y.s``, ``y.y`` and (on the first step) ``|g|_1`` summed over the
    group's ranks, in one ``all_reduce``."""
    parts = [ys, yy] if g1 is None else [ys, yy, g1]
    packed = all_reduce(torch.stack(parts), group)
    return packed[0], packed[1], (packed[2] if g1 is not None else None)
