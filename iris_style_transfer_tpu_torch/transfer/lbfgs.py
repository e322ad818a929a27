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
``torch.where`` or is read by a kernel where it lies; the only host-side
branch is ``iteration == 0``, which the host knows.  History is a circular
buffer: an accepted pair overwrites slot ``count % m`` in place (a step
consumes the state it is given, which saves copying both (m, N) buffers
every closure), and chronological order is a permutation applied to the
(m,) and (m, m) quantities only.  The buffers may be bfloat16 (``dtype``);
their dot products accumulate in float32.

The compact direction needs ``S g``, ``Y g`` and the (m, m) ``SY = S Y'``
and ``YY = Y Y'``.  The state carries SY and YY: a step changes one slot,
so it replaces that slot's row and column, from the dots of the new pair
with every slot.  The work on N is three passes (``ops/lbfgs.py``: the
pair's dots, the slot write with the 5m dots, the direction), hand-written
kernels on a CUDA tensor.

With a process ``group`` the parameter is split over its ranks (the NST's
image batch, ``parallel/mesh.py``), and every inner product is the sum of
the ranks' partial ones: ``y.s``, ``y.y`` and ``|g|_1`` in one
``all_reduce``, the 5m dots of the compact direction in one more.  The
(m,) and (m, m) algebra then runs identically on every rank, and each rank
applies it to its own block.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import lbfgs as L
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
    SY: torch.Tensor  # (m, m) s_i . y_j of the buffers' rows, in slot order (float32)
    YY: torch.Tensor  # (m, m) y_i . y_j, likewise


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
        SY=torch.zeros((m, m), **f32),
        YY=torch.zeros((m, m), **f32),
    )


def _dense(t: torch.Tensor) -> bool:
    """Contiguous, or channels_last: memory with no gaps and no overlap."""
    return t.is_contiguous() or (t.dim() == 4 and t.is_contiguous(memory_format=torch.channels_last))


def _in_gradient_order(state: LBFGSState, g: torch.Tensor) -> LBFGSState:
    """``state`` with its history rows, ``prev_g`` and ``prev_step`` copied
    into ``g``'s memory order where they are in another (channels_last out
    of the VGG stack, against ``lbfgs_init``'s contiguous buffers), so that
    the passes read every vector of N in one order."""
    if state.s_hist[0].stride() == state.prev_g.stride() == state.prev_step.stride() == g.stride():
        return state

    def rows(buf):
        return torch.empty_strided(buf.shape, (g.numel(), *g.stride()), dtype=buf.dtype, device=buf.device).copy_(buf)

    return state._replace(s_hist=rows(state.s_hist), y_hist=rows(state.y_hist),
                          prev_g=torch.empty_like(g).copy_(state.prev_g),
                          prev_step=torch.empty_like(g).copy_(state.prev_step))


def _vdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """float32 full contraction of two parameter-shaped tensors."""
    return (a.float() * b.float()).sum()


def _chron_perm(state: LBFGSState) -> torch.Tensor:
    """Slot indices oldest -> newest: ``(count + i) % m``; never-written
    slots (rho == 0) come first and are masked downstream."""
    m = state.s_hist.shape[0]
    return (state.count + torch.arange(m, device=state.count.device)) % m


def _coefficients(state: LBFGSState, dots: torch.Tensor, slots: torch.Tensor):
    """The compact representation's coefficients of -H @ g (Byrd-Nocedal-
    Schnabel; Nocedal & Wright eq. 7.25): ``-H g = -(gamma g + top @ S +
    gamma bot @ Y)``, from the dots ``S g`` and ``Y g`` (rows 0 and 1 of
    ``dots``) and the state's ``SY`` and ``YY``, all in slot order
    (``slots``: ``arange(m)``).  The chronological permutation and the two
    triangular solves act on (m,) and (m, m) quantities; ``top`` and
    ``bot`` come back in slot order, rounded to the history's type as the
    buffers they multiply."""
    m = state.s_hist.shape[0]
    gamma = state.gamma
    perm = (state.count + slots) % m  # slot indices oldest -> newest (_chron_perm)
    rho_c = state.rho.index_select(0, perm)
    valid = rho_c > 0
    SYc = state.SY.index_select(0, perm).index_select(1, perm)
    YYc = state.YY.index_select(0, perm).index_select(1, perm)
    p, q = torch.where(valid, dots[:2].index_select(1, perm), 0.0)
    q = gamma * q

    # the R/D diagonal is the float32 y.s that acceptance used (1/rho):
    # a bf16 buffer dot of a near-cancelling pair could be zero or negative;
    # never-written slots get 1 so the solves stay well-posed
    D = torch.diag(torch.where(valid, 1.0 / torch.clamp_min(rho_c, 1e-30), 1.0))
    R = torch.triu(SYc, diagonal=1) + D
    Rinv_p = torch.linalg.solve_triangular(R, p[:, None], upper=True)[:, 0]
    DgYY = D + gamma * YYc
    rhs = (DgYY @ Rinv_p - q)[:, None]
    top_c = torch.linalg.solve_triangular(R.t(), rhs, upper=False)[:, 0]

    # back to slot order: slot j sits at chronological position (j-count)%m
    inv = (slots - state.count) % m
    return torch.stack([top_c, -Rinv_p]).index_select(1, inv).to(state.s_hist.dtype).float()


def _carry(SY: torch.Tensor, YY: torch.Tensor, dots: torch.Tensor, new: torch.Tensor):
    """``SY`` and ``YY`` with the row and column of the slot that ``new``
    (an (m,) mask) marks replaced by the new pair's dots (rows 2-4 of
    ``dots``: s_w.Y_j, S_j.y_w, y_w.Y_j); unchanged where it marks none."""
    row, col = new[:, None], new[None, :]
    sY, Sy, yY = dots[2], dots[3], dots[4]
    SY = torch.where(row, sY[None, :], torch.where(col, Sy[:, None], SY))
    YY = torch.where(row, yY[None, :], torch.where(col, yY[:, None], YY))
    return SY, YY


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
    parameter split over the group's ranks.  The passes over N follow
    ``g``'s device (``ops/lbfgs.py:passes``)."""
    return _step(state, g, lr, method, group, L.passes(g.device))


def _step(state: LBFGSState, g: torch.Tensor, lr: float, method: str, group, ops: L.Passes):
    """:func:`lbfgs_step` with the passes ``ops`` (the kernels or the plain
    version)."""
    if group is not None and method != "compact":
        raise ValueError("the two-loop recursion is a one-rank test oracle; a split parameter takes 'compact'")
    m = state.s_hist.shape[0]
    g = g.float()
    if not _dense(g):
        g = g.contiguous()
    if state.iteration == 0:
        state = _in_gradient_order(state, g)
    # y.s, y.y and |g|_1, summed over the group's ranks in one all_reduce
    ys, yy, g1 = all_reduce(ops.pair(g, state.prev_g, state.prev_step), group)

    if state.iteration == 0:  # no pair yet: the scaled gradient
        t = torch.clamp_max(1.0 / torch.clamp_min(g1, 1e-30), 1.0) * lr
        update = t * -g
        return update, state._replace(prev_g=g, prev_step=update, iteration=1)

    accept = ys > 1e-10
    w = (state.count % m).reshape(1)
    slots = torch.arange(m, device=w.device)
    new = accept & (slots == w)  # the slot the pair goes to, if it is taken
    # the pair into slot w (in place: a step consumes the state it is given)
    # and the dots of the compact direction, all ranks' in one all_reduce
    dots = all_reduce(ops.dots(state.s_hist, state.y_hist, g, state.prev_g, state.prev_step, accept, w), group)
    SY, YY = _carry(state.SY, state.YY, dots, new)
    rho = torch.where(new, 1.0 / torch.clamp_min(ys, 1e-30), state.rho)
    gamma = torch.where(accept, ys / torch.clamp_min(yy, 1e-30), state.gamma)
    count = state.count + accept.to(state.count.dtype)
    new = LBFGSState(state.s_hist, state.y_hist, rho, gamma, g, state.prev_step, state.iteration + 1, count, SY, YY)

    if method == "compact":
        top, bot = _coefficients(new, dots, slots)
        update = ops.direction(new.s_hist, new.y_hist, g, top, bot, gamma, lr)
    else:
        update = lr * _two_loop(new, g)
    return update, new._replace(prev_step=update)
