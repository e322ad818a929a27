"""A ``(data, model)`` mesh of ranks on ``torch.distributed``.

Counterpart of ``iris_style_transfer_tpu/parallel/mesh.py``, with its
names.  There, one program runs over a device mesh and XLA inserts the
collectives; here every rank is a process that runs the program on its own
block and issues the collectives itself:

  * the ranks form a ``(data, model)`` grid, rank ``r`` at ``(r // m,
    r % m)`` as JAX's ``reshape(n // m, m)`` lays out its devices, or with
    :func:`make_multislice_mesh` a ``(slice, data, model)`` grid in the
    order of JAX's ``reshape(n_slices, n // (n_slices * m), m)``;
  * the *batch axis* is ``data``, and ``(slice, data)`` on a multislice
    mesh, as JAX's ``_batch_spec`` has it: a rank's batch index is ``r //
    m`` of ``Mesh.batch_shards``, and it reduces over its *data group* (the
    batch group: the ranks of its model index) and its *model group* (the
    ranks of its batch index);
  * a batch is split on its leading axis into contiguous blocks,
    ``[d * B / n, (d + 1) * B / n)`` for batch index ``d`` of ``n``, the
    shards of JAX's ``batch_sharding``; under :func:`spatial_sharding` an
    image batch is also split on H over the model group, and
    :func:`halo_rows` lends each slab its neighbours' edge rows before a
    3x3 conv;
  * parameters are broadcast from rank 0; under a spec, a tensor keeps this
    rank's block along the dimensions the spec names (``mlp_tp_spec``: the
    Megatron split of the classifier heads over ``model``).

The collectives are ``all_reduce``, ``broadcast`` and ``all_gather`` only,
which NCCL and gloo both take on CUDA tensors.  A mesh built outside a
process group has one rank and no group at all, so it issues no collective
and a single-process run computes what it computed without a mesh; so does
a one-rank model group.  The batch group's reductions are one
``all_reduce`` over its ranks: NCCL routes it over NVLink within a node and
over the network between nodes itself.

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

# the device run_ranks gave this process, when it is one of its ranks
_SPAWNED_DEVICE: torch.device | None = None


@dataclass(frozen=True, eq=False)  # hashed by identity: the NST programs are cached per mesh
class Mesh:
    rank: int
    world_size: int
    shape: dict  # {"data": n // m, "model": m}; a multislice mesh has "slice" first
    device: torch.device
    world_group: Any = None  # None: one rank and no process group, no collective
    data_group: Any = None  # the batch group: the (slice, data) ranks of this rank's model index
    model_group: Any = None  # the ranks of this rank's batch index

    @property
    def batch_shards(self) -> int:
        """The blocks of a batch: the ranks of the batch axis, (slice, data)."""
        return self.shape.get("slice", 1) * self.shape["data"]

    @property
    def batch_index(self) -> int:
        """This rank's block of a batch, of :attr:`batch_shards`."""
        return self.rank // self.shape["model"]

    @property
    def slice_index(self) -> int:
        return self.batch_index // self.shape["data"]

    @property
    def data_index(self) -> int:
        return self.batch_index % self.shape["data"]

    @property
    def model_index(self) -> int:
        return self.rank % self.shape["model"]

    @property
    def is_main(self) -> bool:
        """Rank 0, the one rank that writes logs, arrays and checkpoints."""
        return self.rank == 0

    # a spec's "data" names the batch axis, as JAX's _batch_spec does
    def index(self, axis: str) -> int:
        return self.batch_index if axis == "data" else self.model_index

    def size(self, axis: str) -> int:
        return self.batch_shards if axis == "data" else self.shape["model"]

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
    return _form_mesh(n_devices, None, model_parallel, devices, backend)


def make_multislice_mesh(n_slices: int, model_parallel: int = 1, devices=None, backend: str | None = None) -> Mesh:
    """The ``(slice, data, model)`` mesh of this process: rank ``r`` at
    ``(r // (d * m), r // m % d, r % m)`` with ``d = n / (n_slices * m)``,
    the order of JAX's ``make_multislice_mesh``, and the batch split over
    ``(slice, data)``.  Under ``torchrun`` the ranks are node-major, so a
    slice is a run of whole nodes when ``n / n_slices`` is a multiple of
    the ranks a node holds.  The batch group's reductions stay one
    ``all_reduce`` over its ranks (NCCL takes the links between nodes
    itself); ``devices`` and ``backend`` as :func:`make_mesh` takes them."""
    return _form_mesh(None, n_slices, model_parallel, devices, backend)


def _shape(n: int, n_slices: int | None, m: int) -> dict:
    d = n // ((n_slices or 1) * m)
    return {"data": d, "model": m} if n_slices is None else {"slice": n_slices, "data": d, "model": m}


def _form_mesh(n_devices, n_slices: int | None, model_parallel: int, devices, backend) -> Mesh:
    """:func:`make_mesh` (``n_slices`` None) and :func:`make_multislice_mesh`."""
    if not dist.is_initialized() and "WORLD_SIZE" in os.environ:
        device = _rank_device(devices, int(os.environ["RANK"]))
        if device.type == "cuda":
            torch.cuda.set_device(device)
        dist.init_process_group(backend or ("nccl" if device.type == "cuda" else "gloo"), init_method="env://")
    s, m = n_slices or 1, model_parallel
    what = f"model_parallel={m}" if n_slices is None else f"{n_slices} slices x model_parallel={m}"
    if not dist.is_initialized():
        if n_devices not in (None, 0, 1):
            raise ValueError(f"n_devices={n_devices} needs a process group: run the ranks under torchrun "
                             "or run_ranks")
        if s * m != 1:
            raise ValueError(f"1 rank is not divisible by {what}")
        return Mesh(0, 1, _shape(1, n_slices, m), _rank_device(devices, 0))
    n, rank = dist.get_world_size(), dist.get_rank()
    if n_devices not in (None, 0) and n_devices != n:
        raise ValueError(f"n_devices={n_devices}, but the process group has {n} ranks")
    if n % (s * m):
        raise ValueError(f"{n} ranks not divisible by {what}")
    # every rank creates every group, in the same order, as new_group requires
    data_groups = [dist.new_group(list(range(j, n, m))) for j in range(m)]
    model_groups = [dist.new_group(list(range(d * m, (d + 1) * m))) for d in range(n // m)]
    device = _rank_device(devices, rank)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    return Mesh(rank, n, _shape(n, n_slices, m), device, dist.group.WORLD, data_groups[rank % m],
                model_groups[rank // m])


# ---------------------------------------------------------------------------
# batches
# ---------------------------------------------------------------------------


def batch_sharding(mesh: Mesh, batch: int) -> slice:
    """This rank's rows of a batch of ``batch``: the contiguous block of its
    batch index, as JAX's batch axes split a batch."""
    n = mesh.batch_shards
    if batch % n:
        raise ValueError(f"batch size {batch} not divisible by {n} data shards")
    size = batch // n
    return slice(mesh.batch_index * size, (mesh.batch_index + 1) * size)


def shard_batch(mesh: Mesh, tree: Any) -> Any:
    """This rank's block of every tensor and array in ``tree`` (its leading
    axis); a one-rank batch axis returns ``tree`` itself."""
    if mesh.batch_shards == 1:
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
    if mesh is None or mesh.batch_shards * m == 1:
        return None
    b, w = h.shape
    j = mesh.model_index if m > 1 else 0
    rows = slice(mesh.batch_index * b, (mesh.batch_index + 1) * b)
    return (b * mesh.batch_shards, w * m), (rows, slice(j * w, (j + 1) * w))


def make_stager(mesh: Mesh | None):
    """Host array -> this rank's block of it as a tensor on its device; with
    ``None``, a plain ``torch.as_tensor``."""
    if mesh is None:
        return torch.as_tensor
    return lambda a: torch.as_tensor(shard_batch(mesh, a)).to(mesh.device)


def _gather(t: torch.Tensor, group, n: int, dim: int) -> torch.Tensor:
    """Every rank's ``t`` of ``group`` (``n`` ranks), concatenated along
    ``dim`` in rank order."""
    src = t.to(torch.uint8) if t.dtype == torch.bool else t.contiguous()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts, dim)
    return out.to(torch.bool) if t.dtype == torch.bool else out


def gather_batch(mesh: Mesh, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """The global batch from every data rank's block of it (``all_gather``
    over the data group), in batch order, as JAX's ``device_get`` of a
    batch-sharded array sees it; ``dim`` is the batch axis."""
    if mesh.data_group is None or mesh.batch_shards == 1:
        return t
    return _gather(t, mesh.data_group, mesh.batch_shards, dim)


# ---------------------------------------------------------------------------
# images split on H over the model group
# ---------------------------------------------------------------------------

# the 2x2 pools above VGG19's deepest NST tap (relu4_2): a slab must halve
# this many times within itself
SPATIAL_POOLS = 3


def height_sharding(mesh: Mesh, height: int) -> slice:
    """This rank's rows of an image of ``height`` rows: the contiguous block
    of its model index.  Every VGG19 tap down to relu4_1 must split evenly
    too, so that each 2x2 pool stays within a slab: ``(H / 8) % m == 0``,
    as JAX's ``spatial_sharding`` requires; else ``ValueError``.  A
    one-rank model axis keeps every row."""
    m = mesh.shape["model"]
    if m == 1:
        return slice(0, height)
    if height % (2**SPATIAL_POOLS * m):
        raise ValueError(f"an image of height H={height} does not split over model={m}: every VGG19 tap "
                         f"down to relu4_1 (H/8 = {height / 2**SPATIAL_POOLS:g} rows) must divide by {m}, "
                         "so that each 2x2 pool stays within a slab")
    size = height // m
    return slice(mesh.model_index * size, (mesh.model_index + 1) * size)


def spatial_sharding(mesh: Mesh, shape) -> tuple:
    """This rank's block of an NCHW image batch of ``shape``: its data block
    of the batch (:func:`batch_sharding`) and its model block of H
    (:func:`height_sharding`), the shard JAX's ``spatial_sharding`` puts on
    a device; ``x[spatial_sharding(mesh, x.shape)]``.  Undone by
    :func:`gather_height`, then :func:`gather_batch`."""
    return batch_sharding(mesh, shape[0]), slice(None), height_sharding(mesh, shape[2])


def gather_height(mesh: Mesh, t: torch.Tensor, dim: int = -2) -> torch.Tensor:
    """Whole images from every model rank's slab of them (``all_gather``
    over the model group, along H, ``dim``); a one-rank model group
    returns ``t`` with no collective."""
    if mesh.model_group is None or mesh.shape["model"] == 1:
        return t
    return _gather(t, mesh.model_group, mesh.shape["model"], dim)


class _HaloRows(torch.autograd.Function):
    """(B, C, h, W) slab -> (B, C, h + 2, W): the row above from the model
    rank before, the row below from the one after, zeros at the image's
    top and bottom; one ``all_gather`` of every rank's first and last rows.
    The backward gathers the gradients of the lent rows the same way, and
    each rank adds what its neighbours computed for its own edge rows.
    Under a profiler each direction is a span (``runtime/profiler.py``),
    ``halo_rows`` and ``halo_rows_backward``."""

    @staticmethod
    def forward(ctx, x, group, j: int, m: int):
        from ..runtime.profiler import span  # runtime imports this module

        ctx.group, ctx.j, ctx.m = group, j, m
        with span("halo_rows"):
            parts = _edge_rows(x, group, m)
            b, c, h, w = x.shape
            out = _like(x, (b, c, h + 2, w))
            out[:, :, 1:-1] = x
            out[:, :, :1] = parts[j - 1][:, :, 1:] if j > 0 else 0
            out[:, :, -1:] = parts[j + 1][:, :, :1] if j < m - 1 else 0
        return out

    @staticmethod
    def backward(ctx, g):
        from ..runtime.profiler import span

        j, m = ctx.j, ctx.m
        with span("halo_rows_backward"):
            parts = _edge_rows(g, ctx.group, m)  # the cotangents of the rows each rank borrowed
            gx = _like(g, (g.shape[0], g.shape[1], g.shape[2] - 2, g.shape[3]))
            gx.copy_(g[:, :, 1:-1])
            if j > 0:  # the rank before borrowed this slab's first row as its last halo row
                gx[:, :, :1] += parts[j - 1][:, :, 1:]
            if j < m - 1:  # the rank after borrowed the last row as its first
                gx[:, :, -1:] += parts[j + 1][:, :, :1]
        return gx, None, None, None


def _like(x: torch.Tensor, shape) -> torch.Tensor:
    """An empty tensor of ``shape`` in ``x``'s dtype and device, channels_last
    when ``x``'s channels are innermost (also for a view of rows, as
    conv1_1's slab is)."""
    fmt = torch.channels_last if x.stride(1) == 1 and x.shape[1] > 1 else torch.contiguous_format
    return torch.empty(shape, dtype=x.dtype, device=x.device, memory_format=fmt)


def _edge_rows(x: torch.Tensor, group, m: int) -> list[torch.Tensor]:
    """Every model rank's (first, last) rows of its slab, (B, C, 2, W) each."""
    edges = torch.cat([x[:, :, :1], x[:, :, -1:]], dim=2).contiguous()
    parts = [torch.empty_like(edges) for _ in range(m)]
    dist.all_gather(parts, edges, group=group)
    return parts


def halo_rows(x: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """``x``, this rank's (B, C, h, W) slab of an image batch split on H
    over the model group, with one halo row on each side (zeros at the
    image's edges): what a 3x3 conv with ``padding=(0, 1)`` needs to give
    this slab's rows of the whole image's conv.  Differentiable; the
    identity without a model group."""
    if mesh is None or mesh.model_group is None or mesh.shape["model"] == 1:
        return x
    return _HaloRows.apply(x, mesh.model_group, mesh.model_index, mesh.shape["model"])


class _SumOverGroup(torch.autograd.Function):
    """``t`` added over the group's ranks; identity backward."""

    @staticmethod
    def forward(ctx, t, group):
        return all_reduce(t.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def sum_over_group(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of every rank's ``t`` over ``group``, for ranks that go on to
    compute one function of it alike (the Megatron row-parallel reduction;
    the stats of an image whose slabs the ranks hold): its backward hands
    each addend the cotangent of the sum, unchanged.  The identity where
    ``group`` is None."""
    return t if group is None else _SumOverGroup.apply(t, group)


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
        n = mesh.size(ax)
        if n > 1:
            size = t.shape[dim] // n
            t = t.narrow(dim, mesh.index(ax) * size, size).clone()
    return t


def gather_leaf(mesh: Mesh, t: torch.Tensor, s) -> torch.Tensor:
    """The whole tensor from every rank's block of it (``all_gather`` over
    the group of each axis ``s`` names): :func:`shard_leaf` undone."""
    for dim, ax in _split_dims(t, s):
        if mesh.size(ax) > 1:
            t = _gather(t.detach(), mesh.group(ax), mesh.size(ax), dim)
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
    if mesh.data_group is None or mesh.batch_shards == 1:
        return
    grads = [p.grad for p in params]
    flat = torch.cat([g.reshape(-1) for g in grads])
    all_reduce(flat, mesh.data_group).div_(mesh.batch_shards)
    for g, part in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(part.view_as(g))


def pmean_metrics(metrics: dict, mesh: Mesh) -> dict:
    """The mean of each metric over the data group, in one packed
    ``all_reduce``; unchanged on a one-rank mesh."""
    if mesh.data_group is None:
        return metrics
    vals = torch.tensor([float(v) for v in metrics.values()], dtype=torch.float64, device=mesh.device)
    all_reduce(vals, mesh.data_group).div_(mesh.batch_shards)
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
