"""Checkpoints: parameters in the JAX package's format, and the full
training state for ``--resume``.

Counterpart of ``iris_style_transfer_tpu/runtime/checkpoint.py``, with the
same file names in a checkpoint directory:

  * ``step_%08d.npz`` (:func:`save_checkpoint`, :func:`restore_checkpoint`,
    :func:`restore_params`): a tree such as ``{"params": ..., "step": n}``
    with the parameters in the JAX layout (``models/port.py:to_jax``), so
    the JAX package's ``restore_checkpoint`` and the port's
    :func:`restore_params` (an IST main's ``-path1/-path2``) both read it.
    An exact file loads that file, a directory loads its latest step, an
    empty path returns ``default``, a named but missing path raises.
  * ``state_%08d.npz`` (:func:`save_state`, :func:`restore_state`): the
    port's own (params, Adam state, epoch) leaves stored positionally,
    restored into a template of the same structure; read only by the port.

On a mesh (``parallel/mesh.py``) the files always hold the whole
parameters: :func:`save_training_state` gathers the blocks that a spec
split over the ranks and rank 0 alone writes, and
:func:`resume_training_state` reads the whole state on every rank and
cuts each rank's blocks from it, so a run resumes at any rank count.
"""

from __future__ import annotations

import os
import re

import numpy as np
import torch
import torch.utils._pytree as pytree

from ..models.port import from_jax, load_npz, save_npz
from ..parallel.mesh import Mesh, gather_leaf, gather_params, shard_leaf, shard_params, spec_leaves


def _latest(ckpt_dir: str, stem: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(m.group(1)) for f in os.listdir(ckpt_dir) if (m := re.match(rf"{stem}_(\d+)\.npz$", f))]
    return max(steps) if steps else None


def save_checkpoint(ckpt_dir: str, step: int, state: dict) -> str:
    """Save a tree of tensors and numbers at ``step`` in the JAX layout."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"step_{step:08d}.npz")
    save_npz(path, state)
    return path


def latest_step(ckpt_dir: str) -> int | None:
    return _latest(ckpt_dir, "step")


def restore_checkpoint(ckpt_dir: str, step: int | None = None) -> tuple[int, dict] | None:
    """The given (or latest) checkpoint as (step, JAX-layout numpy tree)."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            return None
    return step, load_npz(os.path.join(ckpt_dir, f"step_{step:08d}.npz"))


def restore_checkpoint_file(path: str) -> tuple[int, dict]:
    """The exact checkpoint file named (as the reference loads the epoch
    file passed on its command line), as (step, JAX-layout numpy tree); the
    step is parsed from a ``step_<n>.npz`` name, else 0."""
    m = re.search(r"step_(\d+)\.npz$", os.path.basename(path))
    return (int(m.group(1)) if m else 0), load_npz(path)


def restore_params(path: str | None, default=None, device="cpu"):
    if not path:
        return default
    if not os.path.isfile(path):
        step = latest_step(path)
        if step is None:
            raise FileNotFoundError(f"checkpoint not found: {path}")
        path = os.path.join(path, f"step_{step:08d}.npz")
    return from_jax(restore_checkpoint_file(path)[1]["params"], device=device)


def save_state(ckpt_dir: str, step: int, state) -> str:
    """Save any tree of tensors (params, optimizer state, counters) at
    ``step``, its leaves stored positionally."""
    os.makedirs(ckpt_dir, exist_ok=True)
    leaves = [t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
              for t in pytree.tree_leaves(state)]
    path = os.path.join(ckpt_dir, f"state_{step:08d}.npz")
    np.savez(path, **{f"leaf_{i:05d}": a for i, a in enumerate(leaves)})
    return path


def latest_state_step(ckpt_dir: str) -> int | None:
    return _latest(ckpt_dir, "state")


def restore_state(ckpt_dir: str, template, step: int | None = None):
    """A tree saved by :func:`save_state`, rebuilt in ``template``'s
    structure with each leaf as a tensor on its template leaf's device and
    dtype; returns (step, state) or None when there is none."""
    if step is None:
        step = latest_state_step(ckpt_dir)
        if step is None:
            return None
    with np.load(os.path.join(ckpt_dir, f"state_{step:08d}.npz")) as f:
        leaves = [f[k] for k in sorted(f.files)]
    tmpl, spec = pytree.tree_flatten(template)
    if len(leaves) != len(tmpl):
        raise ValueError(f"state_{step:08d}.npz holds {len(leaves)} leaves; the template has {len(tmpl)}")
    out = [torch.as_tensor(a).to(device=t.device, dtype=t.dtype) if isinstance(t, torch.Tensor) else type(t)(a)
           for a, t in zip(leaves, tmpl)]
    return step, pytree.tree_unflatten(out, spec)


def trainable(tree) -> list[torch.Tensor]:
    """Every leaf of a parameter tree, marked as requiring grad, in tree
    order: the optimizer's parameter list."""
    leaves = pytree.tree_leaves(tree)
    for t in leaves:
        t.requires_grad_(True)
    return leaves


def adam_state(opt: torch.optim.Adam) -> list[dict]:
    """``opt``'s per-parameter state (step, first and second moments) in
    parameter order; zeros for a parameter that has taken no step yet."""
    out = []
    for p in opt.param_groups[0]["params"]:
        st = opt.state.get(p) or {}
        out.append({
            "step": st.get("step", torch.tensor(0.0)),
            "exp_avg": st.get("exp_avg", torch.zeros_like(p)),
            "exp_avg_sq": st.get("exp_avg_sq", torch.zeros_like(p)),
        })
    return out


def load_adam_state(opt: torch.optim.Adam, state: list[dict]) -> None:
    """Put a state from :func:`adam_state` back into ``opt``."""
    for p, st in zip(opt.param_groups[0]["params"], state, strict=True):
        opt.state[p] = {k: v.clone() for k, v in st.items()}


def _map_adam(fn, state: list[dict], specs: list) -> list[dict]:
    """``fn(moment, spec)`` over the moments of an :func:`adam_state`."""
    return [{k: v if k == "step" else fn(v, sp) for k, v in st.items()} for st, sp in zip(state, specs, strict=True)]


def save_training_state(ckpt_dir: str, epoch: int, params, opt: torch.optim.Adam,
                        mesh: Mesh | None = None, spec=None) -> None:
    """Both files of an epoch: the parameters for the JAX package and the
    IST mains (``step_``), and params + Adam state + epoch for ``--resume``
    (``state_``).  On a ``mesh`` every rank calls it: the blocks split by
    ``spec`` are gathered, and rank 0 writes."""
    state = adam_state(opt)
    if mesh is not None and spec is not None:
        specs = spec_leaves(params, spec)
        params = gather_params(mesh, params, spec)
        state = _map_adam(lambda t, sp: gather_leaf(mesh, t, sp), state, specs)
    if mesh is None or mesh.is_main:
        save_checkpoint(ckpt_dir, epoch, {"params": params, "step": epoch})
        save_state(ckpt_dir, epoch, (params, state, epoch))


def resume_training_state(ckpt_dir: str, params, opt: torch.optim.Adam,
                          mesh: Mesh | None = None, spec=None) -> int:
    """Load the latest ``state_`` file of ``ckpt_dir`` into ``params`` (in
    place, so ``opt`` keeps its references) and ``opt``; returns the epoch
    to start from, 0 when there is no state.  On a ``mesh`` (every rank
    calls it) each rank keeps its blocks under ``spec``."""
    restored = restore_state(ckpt_dir, (params, adam_state(opt), 0))
    if restored is None:
        return 0
    epoch, (saved, state, _) = restored
    if mesh is not None and spec is not None:
        state = _map_adam(lambda t, sp: shard_leaf(mesh, t, sp), state, spec_leaves(params, spec))
        saved = shard_params(mesh, saved, spec)
    with torch.no_grad():
        for p, q in zip(pytree.tree_leaves(params), pytree.tree_leaves(saved), strict=True):
            p.copy_(q)
    load_adam_state(opt, state)
    return epoch
