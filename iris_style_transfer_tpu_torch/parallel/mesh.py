"""A ``(data, model)`` mesh of ranks on ``torch.distributed``.

Counterpart of ``iris_style_transfer_tpu/parallel/mesh.py``, with its
names.  There, one program runs over a device mesh and XLA inserts the
collectives; here every rank is a process that runs the program on its own
block and issues the collectives itself:

  * the ranks form a ``(data, model)`` grid, rank ``r`` at ``(r // m,
    r % m)`` as JAX's ``reshape(n // m, m)`` lays out its devices; a rank
    reduces over its *data group* (the ranks of its model index) and its
    *model group* (the ranks of its data index);
  * a batch is split on its leading axis into contiguous blocks,
    ``[d * B / n, (d + 1) * B / n)`` for data index ``d`` of ``n``, the
    shards of JAX's ``batch_sharding``;
  * parameters are broadcast from rank 0; under a spec, a tensor keeps this
    rank's block along the dimensions the spec names (``mlp_tp_spec``: the
    Megatron split of the classifier heads over ``model``).

The collectives are ``all_reduce``, ``broadcast`` and ``all_gather`` only,
which NCCL and gloo both take on CUDA tensors.  A mesh built outside a
process group has one rank and no group at all, so it issues no collective
and a single-process run computes what it computed without a mesh.

:func:`run_ranks` spawns the ranks of one host (``torch.multiprocessing``,
``spawn``), with a ``file://`` rendezvous in a temporary directory.
"""

from __future__ import annotations

import datetime
import os
import tempfile
import time
import traceback
from dataclasses import dataclass
from multiprocessing.connection import wait as _wait_sentinels
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist
import torch.utils._pytree as pytree

# ROADMAP items of the parts of the JAX module that are not ported yet
SPATIAL_ITEM = "ROADMAP §1 item 15 (spatial sharding)"
MULTISLICE_ITEM = "ROADMAP §1 item 16 (multi-node meshes)"

# the device run_ranks gave this process, when it is one of its ranks
_SPAWNED_DEVICE: torch.device | None = None


@dataclass(frozen=True, eq=False)  # hashed by identity: the NST programs are cached per mesh
class Mesh:
    rank: int
    world_size: int
    shape: dict  # {"data": n // m, "model": m}
    device: torch.device
    world_group: Any = None  # None: one rank and no process group, no collective
    data_group: Any = None  # the ranks of this rank's model index
    model_group: Any = None  # the ranks of this rank's data index

    @property
    def data_index(self) -> int:
        return self.rank // self.shape["model"]

    @property
    def model_index(self) -> int:
        return self.rank % self.shape["model"]

    @property
    def is_main(self) -> bool:
        """Rank 0, the one rank that writes logs, arrays and checkpoints."""
        return self.rank == 0

    def index(self, axis: str) -> int:
        return self.data_index if axis == "data" else self.model_index

    def group(self, axis: str):
        return self.data_group if axis == "data" else self.model_group


def one_rank(device) -> Mesh:
    """The mesh of a run on one device: no group, no collective."""
    return Mesh(0, 1, {"data": 1, "model": 1}, torch.device(device))


def _rank_device(devices, rank: int) -> torch.device:
    if devices is not None:
        return torch.device(devices[rank])
    if _SPAWNED_DEVICE is not None:
        return _SPAWNED_DEVICE
    if torch.cuda.is_available():
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    return torch.device("cpu")


def make_mesh(n_devices: int | None = None, model_parallel: int = 1, devices=None, backend: str | None = None) -> Mesh:
    """The ``(data, model)`` mesh of this process.

    Outside a process group with ``n_devices`` in (None, 0, 1): one rank on
    ``devices[0]`` (else ``cuda:LOCAL_RANK``, else the CPU), with no group.
    Under ``torchrun`` (``WORLD_SIZE`` in the environment) the process group
    is initialized here from the environment.  Inside a process group,
    ``n_devices``, when given, must be its world size.  Rank ``r`` runs on
    ``devices[r]`` when ``devices`` lists one device per rank, else on the
    device :func:`run_ranks` gave it, else on ``cuda:LOCAL_RANK``.  The
    backend is ``nccl`` for a CUDA device and ``gloo`` for the CPU, unless
    ``backend`` says otherwise."""
    if not dist.is_initialized() and "WORLD_SIZE" in os.environ:
        device = _rank_device(devices, int(os.environ["RANK"]))
        if device.type == "cuda":
            torch.cuda.set_device(device)
        dist.init_process_group(backend or ("nccl" if device.type == "cuda" else "gloo"), init_method="env://")
    if not dist.is_initialized():
        if n_devices not in (None, 0, 1):
            raise ValueError(f"n_devices={n_devices} needs a process group: run the ranks under torchrun "
                             "or run_ranks")
        if model_parallel != 1:
            raise ValueError(f"1 rank is not divisible by model_parallel={model_parallel}")
        return one_rank(_rank_device(devices, 0))
    n, rank = dist.get_world_size(), dist.get_rank()
    if n_devices not in (None, 0) and n_devices != n:
        raise ValueError(f"n_devices={n_devices}, but the process group has {n} ranks")
    if n % model_parallel:
        raise ValueError(f"{n} ranks not divisible by model_parallel={model_parallel}")
    m = model_parallel
    # every rank creates every group, in the same order, as new_group requires
    data_groups = [dist.new_group(list(range(j, n, m))) for j in range(m)]
    model_groups = [dist.new_group(list(range(d * m, (d + 1) * m))) for d in range(n // m)]
    device = _rank_device(devices, rank)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    return Mesh(rank, n, {"data": n // m, "model": m}, device, dist.group.WORLD,
                data_groups[rank % m], model_groups[rank // m])


def make_multislice_mesh(n_slices: int, model_parallel: int = 1, devices=None) -> Mesh:
    """Not ported yet: hierarchical data groups across nodes."""
    raise NotImplementedError(f"make_multislice_mesh is not ported yet: {MULTISLICE_ITEM}")


def spatial_sharding(mesh: Mesh, ndim: int = 4):
    """Not ported yet: images split on H over ``model``, with a halo
    exchange per conv and the Gram and stats sums reduced over ``model``."""
    raise NotImplementedError(f"spatial_sharding is not ported yet: {SPATIAL_ITEM}")


# ---------------------------------------------------------------------------
# batches
# ---------------------------------------------------------------------------


def batch_sharding(mesh: Mesh, batch: int) -> slice:
    """This rank's rows of a batch of ``batch``: the contiguous block of its
    data index, as JAX's data axis splits a batch."""
    n = mesh.shape["data"]
    if batch % n:
        raise ValueError(f"batch size {batch} not divisible by {n} data shards")
    size = batch // n
    return slice(mesh.data_index * size, (mesh.data_index + 1) * size)


def shard_batch(mesh: Mesh, tree: Any) -> Any:
    """This rank's block of every tensor and array in ``tree`` (its leading
    axis); a one-rank data axis returns ``tree`` itself."""
    if mesh.shape["data"] == 1:
        return tree

    def take(a):
        return a[batch_sharding(mesh, len(a))] if isinstance(a, (torch.Tensor, np.ndarray)) else a

    return pytree.tree_map(take, tree)


def activation_block(mesh: Mesh | None, h: torch.Tensor, split_model: bool = False):
    """``(shape, index)`` of a (B, W) activation ``h`` in that of the whole
    batch: this rank's rows, and its model slice of the columns when
    ``split_model``; None when ``h`` is the whole activation.  Dropout draws
    its mask for ``shape`` and keeps ``[index]`` (``models/layers.py``)."""
    m = mesh.shape["model"] if mesh is not None and split_model else 1
    if mesh is None or mesh.shape["data"] * m == 1:
        return None
    b, w = h.shape
    j = mesh.model_index if m > 1 else 0
    rows = slice(mesh.data_index * b, (mesh.data_index + 1) * b)
    return (b * mesh.shape["data"], w * m), (rows, slice(j * w, (j + 1) * w))


def make_stager(mesh: Mesh | None):
    """Host array -> this rank's block of it as a tensor on its device; with
    ``None``, a plain ``torch.as_tensor``."""
    if mesh is None:
        return torch.as_tensor
    return lambda a: torch.as_tensor(shard_batch(mesh, a)).to(mesh.device)


def gather_batch(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """The global batch from every data rank's block of it (``all_gather``
    over the data group), in batch order, as JAX's ``device_get`` of a
    batch-sharded array sees it."""
    if mesh.data_group is None or mesh.shape["data"] == 1:
        return t
    src = t.to(torch.uint8) if t.dtype == torch.bool else t.contiguous()
    parts = [torch.empty_like(src) for _ in range(mesh.shape["data"])]
    dist.all_gather(parts, src, group=mesh.data_group)
    out = torch.cat(parts)
    return out.to(torch.bool) if t.dtype == torch.bool else out


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


def _walk(fn, params, spec):
    """``fn(leaf, leaf_spec)`` over ``params`` with ``spec`` aligned to it; a
    missing or None spec entry is ``None`` (replicated)."""
    if isinstance(params, dict):
        sd = spec if isinstance(spec, dict) else {}
        return {k: _walk(fn, v, sd.get(k)) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        ss = spec if isinstance(spec, (list, tuple)) and len(spec) == len(params) else [None] * len(params)
        return type(params)(_walk(fn, v, s) for v, s in zip(params, ss))
    return fn(params, spec)


def spec_leaves(params, spec) -> list:
    """Each leaf's spec entry, in ``pytree.tree_leaves(params)`` order."""
    out = []
    _walk(lambda t, s: out.append(s), params, spec)
    return out


def _split_dims(t: torch.Tensor, s) -> list[tuple[int, str]]:
    return [(i, ax) for i, ax in enumerate(s or ()) if ax is not None and i < t.dim()]


def shard_leaf(mesh: Mesh, t: torch.Tensor, s) -> torch.Tensor:
    """Rank 0's ``t`` (``broadcast`` over every rank), cut to this rank's
    block along each dimension that ``s`` names an axis for."""
    if not isinstance(t, torch.Tensor):
        return t
    if mesh.world_group is not None:
        dist.broadcast(t, 0)
    for dim, ax in _split_dims(t, s):
        n = mesh.shape[ax]
        if n > 1:
            size = t.shape[dim] // n
            t = t.narrow(dim, mesh.index(ax) * size, size).clone()
    return t


def gather_leaf(mesh: Mesh, t: torch.Tensor, s) -> torch.Tensor:
    """The whole tensor from every rank's block of it (``all_gather`` over
    the group of each axis ``s`` names): :func:`shard_leaf` undone."""
    for dim, ax in _split_dims(t, s):
        if mesh.shape[ax] > 1:
            src = t.detach().contiguous()
            parts = [torch.empty_like(src) for _ in range(mesh.shape[ax])]
            dist.all_gather(parts, src, group=mesh.group(ax))
            t = torch.cat(parts, dim)
    return t


def shard_params(mesh: Mesh, params: Any, spec: Any = None) -> Any:
    """Every tensor of ``params`` broadcast from rank 0, and cut under
    ``spec`` (a possibly partial tree of per-dimension axis tuples, such as
    ``("model", None)``): entries that are missing or None replicate."""
    return _walk(lambda t, s: shard_leaf(mesh, t, s), params, spec)


def gather_params(mesh: Mesh, params: Any, spec: Any = None) -> Any:
    """The whole parameters from each rank's blocks under ``spec``."""
    return _walk(lambda t, s: gather_leaf(mesh, t, s), params, spec)


def replicated(mesh: Mesh, params: Any) -> Any:
    """Every tensor of ``params`` as rank 0 holds it."""
    return shard_params(mesh, params)


def mlp_tp_spec(params: dict | None = None) -> dict:
    """Tensor-parallel spec of a 3-layer MLP head ({'fc0','fc1','fc2'}) in
    the port's (out, in) layout: fc0 column-parallel (its outputs split),
    fc1 row-parallel (its inputs split, one all-reduce per forward), fc2
    replicated."""
    return {
        "fc0": {"w": ("model", None), "b": ("model",)},
        "fc1": {"w": (None, "model"), "b": ()},
        "fc2": {"w": (), "b": ()},
    }


# ---------------------------------------------------------------------------
# reductions
# ---------------------------------------------------------------------------


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` over ``group`` in place; the identity where ``group`` is
    None (a one-rank mesh)."""
    if group is not None:
        dist.all_reduce(t, group=group)
    return t


def pmean_grads(mesh: Mesh, params: list[torch.Tensor]) -> None:
    """Replace each parameter's gradient by its mean over the data group, in
    one packed ``all_reduce``, so that the optimizer makes the same update
    on every data rank."""
    if mesh.data_group is None or mesh.shape["data"] == 1:
        return
    grads = [p.grad for p in params]
    flat = torch.cat([g.reshape(-1) for g in grads])
    all_reduce(flat, mesh.data_group).div_(mesh.shape["data"])
    for g, part in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(part.view_as(g))


def pmean_metrics(metrics: dict, mesh: Mesh) -> dict:
    """The mean of each metric over the data group, in one packed
    ``all_reduce``; unchanged on a one-rank mesh."""
    if mesh.data_group is None:
        return metrics
    vals = torch.tensor([float(v) for v in metrics.values()], dtype=torch.float64, device=mesh.device)
    all_reduce(vals, mesh.data_group).div_(mesh.shape["data"])
    return dict(zip(metrics, vals.tolist()))


def barrier(mesh: Mesh) -> None:
    """Return only when every rank has reached this call: rank 0's files are
    then written for everyone to read.  (An ``all_reduce`` read back on the
    host, since a CUDA collective alone does not block the host.)"""
    if mesh.world_group is not None:
        t = torch.ones(1, device=mesh.device)
        dist.all_reduce(t)
        t.item()


# ---------------------------------------------------------------------------
# spawning the ranks of one host
# ---------------------------------------------------------------------------


def _rank_main(fn, rank: int, n: int, devices, backend, tmp: str, threads: int) -> None:
    global _SPAWNED_DEVICE
    try:
        device = torch.device(devices[rank]) if devices is not None else (
            torch.device("cuda", rank) if torch.cuda.is_available() else torch.device("cpu"))
        _SPAWNED_DEVICE = device
        if device.type == "cuda":
            torch.cuda.set_device(device)
        # torchrun's default: one intra-op thread a rank when there are
        # several (ranks that each take the host's cores oversubscribe it)
        torch.set_num_threads(threads if n == 1 else 1)
        dist.init_process_group(backend or ("nccl" if device.type == "cuda" else "gloo"),
                                init_method=f"file://{os.path.join(tmp, 'rendezvous')}", rank=rank, world_size=n,
                                timeout=datetime.timedelta(minutes=10))
        out = fn()
        if rank == 0:
            torch.save(out, os.path.join(tmp, "result.pt"))
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(tmp, f"rank{rank}.err"), "w") as fh:
            fh.write(traceback.format_exc())
        # no clean-up: a peer may be blocked in a collective with this rank
        os._exit(1)


def run_ranks(fn: Callable[[], Any], n: int, devices=None, backend: str | None = None,
              timeout: float | None = None) -> Any:
    """Run ``fn()`` on ``n`` spawned ranks of a fresh process group and
    return rank 0's result.  ``fn`` must pickle (a module-level function or
    a ``functools.partial`` of one).  Rank ``r`` runs on ``devices[r]``,
    else on ``cuda:r`` (the CPU without CUDA); the backend as
    :func:`make_mesh` picks it.  A rank that fails makes the call raise
    with its traceback, after the other ranks are killed; so does a run
    that outlasts ``timeout`` seconds."""
    ctx = torch.multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=_rank_main, args=(fn, r, n, devices, backend, tmp, torch.get_num_threads()),
                             daemon=True) for r in range(n)]
        for p in procs:
            p.start()
        try:
            _join(procs, timeout, tmp)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join()
        return torch.load(os.path.join(tmp, "result.pt"), weights_only=False)


def _join(procs, timeout: float | None, tmp: str) -> None:
    deadline = None if timeout is None else time.monotonic() + timeout
    alive = list(procs)
    while alive:
        left = None if deadline is None else deadline - time.monotonic()
        if left is not None and left <= 0:
            raise TimeoutError(f"{len(alive)} of {len(procs)} ranks still running after {timeout} s")
        _wait_sentinels([p.sentinel for p in alive], left)
        for r, p in enumerate(procs):
            if p in alive and not p.is_alive():
                alive.remove(p)
                if p.exitcode != 0:
                    err = os.path.join(tmp, f"rank{r}.err")
                    msg = open(err).read() if os.path.exists(err) else f"exit code {p.exitcode}"
                    raise RuntimeError(f"rank {r} of {len(procs)} failed:\n{msg}")
