"""The ``(slice, data, model)`` mesh (``parallel/mesh.py:make_multislice_mesh``)
on four gloo ranks on the CPU, against JAX's ``make_multislice_mesh`` and
against one rank.

Each mesh is formed once, by one ``run_ranks`` spawn of four ranks (each
join bounded by :data:`JOIN_S`), which returns every rank's coordinates
and batch block and rank 0's NST results, whole.  Inputs are made with
numpy from a seed, on seeded VGG19 weights truncated at relu4_2, in
float32.  Tolerances:

  * ``make_multislice_mesh(2)``: each rank's (slice, data, model) and
    batch block are those of JAX's device of the same index on
    ``make_multislice_mesh(2)`` over 4 virtual devices with
    ``batch_sharding``, exactly;
  * the NST on it at JAX's (8, 32, 32, 3) against one rank: 5 closures
    at JAX's ``atol`` of 2e-3 on the image (``tests/test_parallel.py``,
    the multislice test); over 3 closures, the losses of closures 0 and 1
    (before L-BFGS's first curvature pair) to rtol 1e-5, and the image
    after the first step to atol 1e-6;
  * ``spatial_sharding`` on ``make_multislice_mesh(2, model_parallel=2)``:
    each image's H split over the model pairs, the batch over the slices;
    the NST against one rank as above, but its 5-closure image as JAX's
    spatial test holds its own (``tests/test_parallel.py:69-103``: mean
    |dx| < 1e-3, max |dx| < 5e-2; here a few pixels of 24,576 part by up
    to 2.6e-3).
"""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch
import torch.distributed as dist

from iris_style_transfer_tpu_torch.models import VGG19
from iris_style_transfer_tpu_torch.parallel import batch_sharding, make_multislice_mesh, run_ranks, spatial_sharding
from iris_style_transfer_tpu_torch.transfer.nst import make_nst_fn

JOIN_S = 120  # every spawned run fails after this many seconds
SHAPE = (8, 3, 32, 32)  # JAX's multislice test's images, NCHW
PAIR_FREE = 2  # closures before L-BFGS's first curvature pair


def _images():
    rng = np.random.default_rng(3)
    c = rng.random((SHAPE[0], SHAPE[2], SHAPE[3], SHAPE[1]))
    s = rng.random((SHAPE[0], SHAPE[2], SHAPE[3], SHAPE[1]))
    return tuple(torch.from_numpy(a.astype(np.float32)).permute(0, 3, 1, 2).contiguous() for a in (c, s))


def _nst(mesh, epochs: int):
    c, s = _images()
    if mesh is not None:
        c, s = (t[spatial_sharding(mesh, t.shape)] for t in (c, s))
    fn = make_nst_fn(epochs=epochs, history_every=1, mesh=mesh)
    return fn(VGG19.init(torch.Generator().manual_seed(0)), c, s, gather=True)


def _rank_multislice(model_parallel: int):
    """One of four ranks: its coordinates and batch block, gathered from
    every rank, and the NST at 5 and at 3 closures, whole."""
    mesh = make_multislice_mesh(2, model_parallel=model_parallel)
    block = batch_sharding(mesh, SHAPE[0])
    me = ((mesh.slice_index, mesh.data_index, mesh.model_index), (block.start, block.stop))
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, me)
    return mesh.shape, every, _nst(mesh, 5), _nst(mesh, 3)


@pytest.fixture(scope="module", params=[1, 2], ids=["model1", "model2"])
def multislice(request):
    return request.param, run_ranks(functools.partial(_rank_multislice, request.param), 4,
                                    devices=["cpu"] * 4, timeout=JOIN_S)


@pytest.fixture(scope="module")
def one_rank_nst():
    return _nst(None, 5), _nst(None, 3)


def test_ranks_sit_where_jax_puts_its_devices(multislice):
    import jax
    from iris_style_transfer_tpu.parallel import batch_sharding as j_batch_sharding
    from iris_style_transfer_tpu.parallel import make_multislice_mesh as j_make_multislice_mesh

    m, (shape, every, _, _) = multislice
    jmesh = j_make_multislice_mesh(2, model_parallel=m, devices=jax.devices()[:4])
    assert shape == dict(zip(jmesh.axis_names, jmesh.devices.shape))
    blocks = j_batch_sharding(jmesh).devices_indices_map((SHAPE[0], 32, 32, 3))
    for rank, (coords, block) in enumerate(every):
        dev = jax.devices()[rank]
        assert coords == tuple(int(i) for i in np.argwhere(jmesh.devices == dev)[0]), rank
        rows = blocks[dev][0]
        assert block == (rows.start or 0, SHAPE[0] if rows.stop is None else rows.stop), rank


def test_nst_on_a_multislice_mesh_equals_one_rank(multislice, one_rank_nst):
    """The batch over (slice, data), and with ``model_parallel=2`` each
    image's H over the model pairs, against one rank."""
    m, (_, _, got5, got3) = multislice
    want5, want3 = one_rank_nst
    if m == 1:
        np.testing.assert_allclose(got5.x.numpy(), want5.x.numpy(), rtol=0, atol=2e-3)
    else:
        dx = (got5.x - want5.x).abs()
        assert dx.mean() < 1e-3 and dx.max() < 5e-2, (dx.mean().item(), dx.max().item())
    k = PAIR_FREE
    np.testing.assert_allclose(got3.s_loss_hist[:k].numpy(), want3.s_loss_hist[:k].numpy(), rtol=1e-5)
    np.testing.assert_allclose(got3.c_loss_hist[:k].numpy(), want3.c_loss_hist[:k].numpy(), rtol=1e-5, atol=1e-12)
    np.testing.assert_allclose(got3.x_hist[1].numpy(), want3.x_hist[1].numpy(), rtol=0, atol=1e-6)
