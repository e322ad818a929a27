"""The port's data and tensor parallelism (``parallel/mesh.py``) on the CPU.

Two ranks on gloo, spawned by ``run_ranks`` with a ``file://`` rendezvous,
each join bounded by :data:`JOIN_S`.  The JAX side runs on the conftest's
virtual CPU devices with ``make_mesh(n_devices=2)`` (or ``model_parallel=2``).
JAX is imported inside the tests only: the spawned ranks import this module
to find their functions, and they run no JAX.

Tolerances, f32 throughout:
  * batch blocks, partial-spec placement and a world-size-1 group: exact;
  * the L-BFGS split in halves against the whole vector: rtol 1e-6 over 15
    steps; against the JAX ``lbfgs_step`` on the same gradients: rtol 1e-5
    and 1e-5 of the update's largest element, as ``tests/test_torch_nst.py``
    holds the one-device step;
  * the NST on 2 ranks against JAX's 2-device NST at (4, 32, 32, 3), 5
    closures: the first closure's losses to rtol 1e-6; the histories to rtol
    1e-3 (JAX's sharded-vs-unsharded test allows 2e-2), mean |dx| < 1e-4
    (JAX: 1e-3) and max |dx| < 5e-2; against the port on one rank the same;
  * the tensor-parallel Classifier2 head against the whole head: 1e-5 of
    the logits' scale (the split changes only the order of fc1's sums),
    and against JAX's head 2e-4 as ``tests/test_parallel.py:184`` holds
    its own split; dropout masks of the split head exact.
"""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch
import torch.distributed as dist

from iris_style_transfer_tpu_torch.models import VGG19, Classifier2
from iris_style_transfer_tpu_torch.models.port import to_jax
from iris_style_transfer_tpu_torch.parallel import (
    gather_batch,
    gather_params,
    make_mesh,
    make_multislice_mesh,
    mlp_tp_spec,
    one_rank,
    pmean_grads,
    pmean_metrics,
    run_ranks,
    shard_batch,
    shard_params,
    spatial_sharding,
)
from iris_style_transfer_tpu_torch.transfer import lbfgs as tlbfgs
from iris_style_transfer_tpu_torch.transfer.nst import make_nst_fn

JOIN_S = 120  # every spawned run fails after this many seconds


def _ranks(fn, n: int = 2):
    return run_ranks(fn, n, devices=["cpu"] * n, timeout=JOIN_S)


def _all(obj):
    """Every rank's ``obj``, in rank order (a test-side helper)."""
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


# ---------------------------------------------------------------------------
# mesh, blocks, parameters
# ---------------------------------------------------------------------------


def _rank_mesh_and_blocks(a):
    m1, m2 = make_mesh(), make_mesh(model_parallel=2)
    return _all({"shapes": (m1.shape, m2.shape), "index": (m1.data_index, m2.data_index, m2.model_index),
                 "block": shard_batch(m1, a), "block_t": shard_batch(m1, torch.from_numpy(a)).numpy(),
                 "block_mp": shard_batch(m2, a), "gathered": gather_batch(m1, shard_batch(m1, torch.from_numpy(a)))})


def test_mesh_shapes_and_batch_blocks_match_jax():
    import jax
    from iris_style_transfer_tpu.parallel import batch_sharding as j_batch_sharding
    from iris_style_transfer_tpu.parallel import make_mesh as j_make_mesh

    a = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
    ranks = _ranks(functools.partial(_rank_mesh_and_blocks, a))
    assert [r["shapes"] for r in ranks] == [({"data": 2, "model": 1}, {"data": 1, "model": 2})] * 2
    assert [r["index"] for r in ranks] == [(0, 0, 0), (1, 0, 1)]

    jmesh = j_make_mesh(n_devices=2)
    assert jmesh.devices.shape == (2, 1) and j_make_mesh(n_devices=2, model_parallel=2).devices.shape == (1, 2)
    arr = jax.device_put(a, j_batch_sharding(jmesh, 2))
    shards = sorted(arr.addressable_shards, key=lambda sh: sh.index[0].start)
    for r, sh in zip(ranks, shards):
        np.testing.assert_array_equal(r["block"], np.asarray(sh.data))
        np.testing.assert_array_equal(r["block_t"], np.asarray(sh.data))
        np.testing.assert_array_equal(r["block_mp"], a)  # one data shard: every model rank sees the batch
        np.testing.assert_array_equal(r["gathered"].numpy(), a)


def test_one_rank_mesh_and_unported_parts():
    mesh = make_mesh()
    assert (mesh.rank, mesh.world_size, mesh.shape, mesh.data_group) == (0, 1, {"data": 1, "model": 1}, None)
    a = np.ones((3, 2))
    assert shard_batch(mesh, a) is a
    with pytest.raises(ValueError, match="process group"):
        make_mesh(n_devices=2)
    with pytest.raises(ValueError, match="model_parallel"):
        make_mesh(model_parallel=2)
    # the parts once unported: a one-rank model group keeps the whole image,
    # and one rank forms a multislice mesh of one slice
    assert spatial_sharding(mesh, (3, 3, 20, 5)) == (slice(0, 3), slice(None), slice(0, 20))
    x = torch.ones(3, 3, 20, 5)
    assert x[spatial_sharding(mesh, x.shape)].shape == x.shape
    ms = make_multislice_mesh(1)
    assert (ms.shape, ms.batch_shards, ms.batch_index, ms.data_group) == ({"slice": 1, "data": 1, "model": 1}, 1, 0,
                                                                         None)
    with pytest.raises(ValueError, match="2 slices"):
        make_multislice_mesh(2)


def _rank_partial_spec():
    mesh = make_mesh()
    r = dist.get_rank()
    params = {"a": {"w": torch.arange(32.0).reshape(8, 4) * (r + 1), "b": torch.ones(4) * (r + 1)},
              "c": [torch.full((2,), float(r))]}
    out = shard_params(mesh, params, spec={"a": {"w": ("data", None)}})
    whole = gather_params(mesh, out, {"a": {"w": ("data", None)}})
    return _all({"w": out["a"]["w"], "b": out["a"]["b"], "c": out["c"][0], "whole": whole["a"]["w"]})


def test_shard_params_partial_spec_replicates_missing():
    """As ``tests/test_parallel.py``'s test of the same name: a spec entry
    that is missing replicates (here: rank 0's values broadcast); the named
    one keeps this rank's rows; ``gather_params`` undoes the split."""
    ranks = _ranks(_rank_partial_spec)
    w0 = torch.arange(32.0).reshape(8, 4)
    for r, got in enumerate(ranks):
        assert torch.equal(got["w"], w0[4 * r: 4 * r + 4])
        assert torch.equal(got["b"], torch.ones(4)) and torch.equal(got["c"], torch.zeros(2))
        assert torch.equal(got["whole"], w0)


# ---------------------------------------------------------------------------
# the joint L-BFGS
# ---------------------------------------------------------------------------


def _problem(n=16, seed=1):
    rng = np.random.default_rng(seed)
    m = rng.standard_normal((n, n)).astype(np.float32)
    return m @ m.T + np.eye(n, dtype=np.float32), rng.standard_normal(n).astype(np.float32), \
        rng.standard_normal(n).astype(np.float32)


def _grad(a, b, x):
    return a @ x - b + 0.4 * x ** 3  # of 0.5 x'Ax - b'x + 0.1 sum(x^4)


def _lbfgs_run(steps: int, mesh=None, grads=None):
    """``steps`` L-BFGS steps (m = 5) from the same start; with a mesh each
    rank holds its half of x and of the state.  With ``grads``, step k takes
    ``grads[k]`` (the open loop).  Returns the whole gradients and updates of
    every step."""
    a, b, x0 = (torch.from_numpy(t) for t in _problem())
    blk = slice(None) if mesh is None else slice(8 * mesh.data_index, 8 * mesh.data_index + 8)
    group = None if mesh is None else mesh.data_group
    x = x0.clone()
    state = tlbfgs.lbfgs_init(x[blk].shape, 5)
    gs, ups = [], []
    for k in range(steps):
        g = _grad(a, b, x) if grads is None else grads[k]
        if k in (4, 9) and grads is None:
            g = -3.0 * g  # y.s < 0: the pair is rejected
        upd, state = tlbfgs.lbfgs_step(state, g[blk], 1.0, group=group)
        whole = upd if mesh is None else gather_batch(mesh, upd)
        gs.append(g)
        ups.append(whole)
        x = x + whole
    return torch.stack(gs), torch.stack(ups), int(state.count)


def _rank_lbfgs(steps, grads):
    return _lbfgs_run(steps, make_mesh(), grads)


def test_lbfgs_on_two_ranks_equals_the_whole_vector_and_jax():
    """Both runs take the whole-vector run's gradients (a quartic, two of
    them flipped so that pairs are rejected); every update of the split run
    equals the whole-vector step's, and JAX's step on the same gradients."""
    import jax.numpy as jnp
    from iris_style_transfer_tpu.transfer import lbfgs as jlbfgs

    gs1, ups1, count1 = _lbfgs_run(15)
    gs, ups, count = _ranks(functools.partial(_rank_lbfgs, 15, gs1))
    assert count == count1 and 0 < count < 15  # pairs accepted and rejected alike
    for u, u1 in zip(ups.numpy(), ups1.numpy()):
        np.testing.assert_allclose(u, u1, rtol=1e-6, atol=1e-6 * np.abs(u1).max())
    js = jlbfgs.lbfgs_init((16,), 5)
    for g, u in zip(gs.numpy(), ups.numpy()):
        ju, js = jlbfgs.lbfgs_step(js, jnp.asarray(g), 1.0)
        np.testing.assert_allclose(u, np.asarray(ju), rtol=1e-5, atol=1e-5 * np.abs(ju).max())
    assert int(js.count) == count


def test_two_loop_oracle_refuses_a_group():
    state = tlbfgs.lbfgs_init(4, 3)._replace(iteration=1)
    with pytest.raises(ValueError, match="one-rank"):
        tlbfgs.lbfgs_step(state, torch.ones(4), method="two_loop", group=object())


# ---------------------------------------------------------------------------
# the joint NST
# ---------------------------------------------------------------------------


def _vgg():
    return VGG19.init(torch.Generator().manual_seed(0))


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _rank_nst(c, s, epochs, stats_taps=False):
    mesh = make_mesh()
    res = make_nst_fn(epochs=epochs, stats_taps=stats_taps, mesh=mesh)(_vgg(), *shard_batch(mesh, (_nchw(c), _nchw(s))))
    return gather_batch(mesh, res.x), res.c_loss_hist, res.s_loss_hist


def _images(seed=0):
    rng = np.random.default_rng(seed)
    return rng.random((4, 32, 32, 3)).astype(np.float32), rng.random((4, 32, 32, 3)).astype(np.float32)


def test_nst_on_two_ranks_matches_the_jax_mesh_and_one_rank():
    """The joint problem across ranks: the content loss is a mean over the
    whole batch and the L-BFGS products are global, so the histories are
    the single-device ones (a port that only split the batch would weigh
    the content loss 2x and run two independent L-BFGS problems)."""
    import jax
    from iris_style_transfer_tpu.parallel import batch_sharding as j_batch_sharding
    from iris_style_transfer_tpu.parallel import make_mesh as j_make_mesh
    from iris_style_transfer_tpu.parallel import shard_params as j_shard_params
    from iris_style_transfer_tpu.transfer.nst import make_nst_fn as j_make_nst_fn

    c, s = _images()
    x2, c2, s2 = _ranks(functools.partial(_rank_nst, c, s, 5))
    one = make_nst_fn(epochs=5)(_vgg(), _nchw(c), _nchw(s))

    jmesh = j_make_mesh(n_devices=2)
    want = jax.jit(j_make_nst_fn(epochs=5))(j_shard_params(jmesh, to_jax(_vgg())),
                                            jax.device_put(c, j_batch_sharding(jmesh)),
                                            jax.device_put(s, j_batch_sharding(jmesh)))
    jc, js = np.asarray(want.c_loss_hist), np.asarray(want.s_loss_hist)
    jx = np.asarray(want.x).transpose(0, 3, 1, 2)
    for got_c, got_s, got_x in ((c2, s2, x2), (one.c_loss_hist, one.s_loss_hist, one.x)):
        np.testing.assert_allclose(got_s[0].item(), js[0], rtol=1e-6)
        np.testing.assert_allclose(got_c[0].item(), jc[0], rtol=1e-6, atol=1e-12)
        np.testing.assert_allclose(got_s.numpy(), js, rtol=1e-3)
        np.testing.assert_allclose(got_c.numpy(), jc, rtol=1e-3, atol=1e-10)
        dx = np.abs(got_x.numpy() - jx)
        assert dx.mean() < 1e-4 and dx.max() < 5e-2, (dx.mean(), dx.max())
    np.testing.assert_allclose(s2.numpy(), one.s_loss_hist.numpy(), rtol=1e-3)
    np.testing.assert_allclose(c2.numpy(), one.c_loss_hist.numpy(), rtol=1e-3, atol=1e-10)
    assert c2[1:].abs().min() > 0  # the content loss moved, and stayed the global mean


# ---------------------------------------------------------------------------
# the tensor-parallel heads
# ---------------------------------------------------------------------------


def _style(seed=2, b=4):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.random((b, ch, 8, 8), dtype=np.float32)) for ch in (64, 128, 256, 512)]


def _head(num_class=10):
    return Classifier2.init(torch.Generator().manual_seed(1), num_class=num_class)


def _head_run(mesh, params, style, train: bool):
    """Logits (gathered), and, in train mode, the whole gradients of the
    head's parameters after the data-parallel mean."""
    params = shard_params(mesh, params, mlp_tp_spec() if mesh.shape["model"] > 1 else None)
    leaves = [t.requires_grad_(True) for t in (params[k][n] for k in ("fc0", "fc1", "fc2") for n in ("w", "b"))]
    gen = torch.Generator().manual_seed(5) if train else None
    out = Classifier2.apply(params, shard_batch(mesh, style), train=train, gen=gen, mesh=mesh)
    if not train:
        return gather_batch(mesh, out.detach())
    out.square().mean().backward()
    pmean_grads(mesh, leaves)
    grads = {k: {n: params[k][n].grad for n in ("w", "b")} for k in ("fc0", "fc1", "fc2")}
    spec = mlp_tp_spec() if mesh.shape["model"] > 1 else None
    return gather_batch(mesh, out.detach()), gather_params(mesh, grads, spec)


def _rank_heads(model_parallel):
    mesh = make_mesh(model_parallel=model_parallel)
    return _head_run(mesh, _head(), _style(), False), _head_run(mesh, _head(), _style(), True)


@pytest.mark.parametrize("model_parallel", [2, 1])
def test_split_classifier2_head_equals_the_whole_head_and_jax(model_parallel):
    """``model_parallel=2``: fc0 column- and fc1 row-parallel (Megatron),
    against the whole head and JAX's head; ``1``: the batch split in two.
    In train mode both draw the whole batch's dropout masks, so logits and
    (data-mean) gradients equal the one-device step's."""
    import jax
    import jax.numpy as jnp
    from iris_style_transfer_tpu.models import Classifier2 as JClassifier2
    from iris_style_transfer_tpu.parallel import batch_sharding as j_batch_sharding
    from iris_style_transfer_tpu.parallel import make_mesh as j_make_mesh
    from iris_style_transfer_tpu.parallel import mlp_tp_spec as j_mlp_tp_spec
    from iris_style_transfer_tpu.parallel import shard_params as j_shard_params

    (logits, (tlogits, grads)) = _ranks(functools.partial(_rank_heads, model_parallel))
    want = _head_run(one_rank("cpu"), _head(), _style(), False)
    twant, gwant = _head_run(one_rank("cpu"), _head(), _style(), True)
    scale = want.abs().max().item()
    np.testing.assert_allclose(logits.numpy(), want.numpy(), atol=1e-5 * scale)
    np.testing.assert_allclose(tlogits.numpy(), twant.numpy(), atol=1e-5 * twant.abs().max().item())
    for k in gwant:
        for n in gwant[k]:
            np.testing.assert_allclose(grads[k][n].numpy(), gwant[k][n].numpy(),
                                       atol=1e-5 * gwant[k][n].abs().max().item(), err_msg=f"{k}.{n}")

    jmesh = j_make_mesh(n_devices=2, model_parallel=model_parallel)
    jp = to_jax(_head())
    if model_parallel > 1:
        jp = j_shard_params(jmesh, jp, j_mlp_tp_spec(jp))
    jstyle = [jax.device_put(jnp.asarray(f.permute(0, 2, 3, 1).numpy()), j_batch_sharding(jmesh)) for f in _style()]
    np.testing.assert_allclose(logits.numpy(), np.asarray(jax.jit(JClassifier2.apply)(jp, jstyle)), atol=2e-4)


# ---------------------------------------------------------------------------
# checkpoints of split heads, resumed at another rank count
# ---------------------------------------------------------------------------


def _small_heads():
    from iris_style_transfer_tpu_torch.models import layers as L

    gen = torch.Generator().manual_seed(3)
    return {"c2": {"fc0": L.init_linear(gen, 6, 8), "fc1": L.init_linear(gen, 8, 8), "fc2": L.init_linear(gen, 8, 3)}}


def _adam_run(mesh, steps: int, ckpt_in: str | None = None, ckpt_out: str | None = None):
    """``steps`` Adam steps of a small head (split over ``model`` when the
    mesh has it), resumed from ``ckpt_in`` and saved to ``ckpt_out``;
    returns the whole parameters."""
    from iris_style_transfer_tpu_torch.models.classifiers import _mlp
    from iris_style_transfer_tpu_torch.runtime.checkpoint import resume_training_state, save_training_state
    from iris_style_transfer_tpu_torch.runtime.checkpoint import trainable

    spec = {"c2": mlp_tp_spec()} if mesh.shape["model"] > 1 else None
    params = shard_params(mesh, _small_heads(), spec)
    opt = torch.optim.Adam(trainable(params), lr=1e-2)
    start = resume_training_state(ckpt_in, params, opt, mesh, spec) if ckpt_in else 0
    x = torch.randn((4, 6), generator=torch.Generator().manual_seed(4))
    for _ in range(start, steps):
        loss = _mlp(params["c2"], shard_batch(mesh, x), mesh=mesh).square().mean()
        opt.zero_grad()
        loss.backward()
        pmean_grads(mesh, opt.param_groups[0]["params"])
        opt.step()
    if ckpt_out:
        save_training_state(ckpt_out, steps, params, opt, mesh, spec)
    whole = gather_params(mesh, params["c2"], spec and spec["c2"])
    return {k: {n: t.detach() for n, t in v.items()} for k, v in whole.items()}


def _rank_adam(model_parallel, steps, ckpt_in, ckpt_out):
    return _adam_run(make_mesh(model_parallel=model_parallel), steps, ckpt_in, ckpt_out)


def test_split_head_checkpoints_resume_at_any_rank_count(tmp_path):
    """Heads split over two ranks save the whole heads (rank 0 writes); one
    rank resumes from them, and two split ranks from one rank's checkpoint,
    each to the one-rank run's parameters after three Adam steps."""
    want = _adam_run(one_rank("cpu"), 3)
    a, b = str(tmp_path / "split"), str(tmp_path / "one")
    _ranks(functools.partial(_rank_adam, 2, 2, None, a))
    assert sorted(p.name for p in (tmp_path / "split").iterdir()) == ["state_00000002.npz", "step_00000002.npz"]
    _adam_run(one_rank("cpu"), 2, None, b)
    for got in (_adam_run(one_rank("cpu"), 3, a), _ranks(functools.partial(_rank_adam, 2, 3, b, None))):
        for k in want:
            for n in want[k]:
                np.testing.assert_allclose(got[k][n].numpy(), want[k][n].numpy(), rtol=1e-5, atol=1e-6,
                                           err_msg=f"{k}.{n}")


# ---------------------------------------------------------------------------
# one rank in a process group is no group at all
# ---------------------------------------------------------------------------


def _world_one_outputs(mesh):
    c, s = _images(3)
    res = make_nst_fn(epochs=3, stats_taps=True, mesh=mesh)(_vgg(), _nchw(c), _nchw(s))
    head = _head_run(mesh, _head(), _style(), True)
    metrics = pmean_metrics({"a": torch.tensor(1.5), "b": 2.0}, mesh)
    return res.x, res.c_loss_hist, res.s_loss_hist, head, {k: float(v) for k, v in metrics.items()}


def _rank_world_one():
    mesh = make_mesh()
    assert mesh.data_group is not None  # collectives are issued, over one rank
    return _world_one_outputs(mesh)


def test_world_size_one_group_equals_no_group():
    got = _ranks(_rank_world_one, 1)
    want = _world_one_outputs(make_mesh())
    for g, w in zip(torch.utils._pytree.tree_leaves(got), torch.utils._pytree.tree_leaves(want)):
        assert torch.equal(g, w) if isinstance(w, torch.Tensor) else g == w


# ---------------------------------------------------------------------------
# the 2020 gaze step, split over the batch
# ---------------------------------------------------------------------------


def _gaze_params():
    from iris_style_transfer_tpu_torch.models import EfficientNet, GazeEstimator1, GazeEstimator2

    gen = torch.Generator().manual_seed(11)
    return (EfficientNet.init(gen), GazeEstimator1.init(gen), GazeEstimator2.init(gen, extract_feature=True),
            VGG19.init(gen))


def _gaze_step(mesh, frames):
    """``tests/test_parallel.py:200``'s step: B7 segmentation, both
    estimators, the iris crops, a 2-closure NST with the batch's first iris
    as every style, the composite, B7 and estimator 1 again.  ``frames`` is
    the whole (B, H, W, 1) batch; returns the whole batch's outputs."""
    from iris_style_transfer_tpu_torch.models import EfficientNet, GazeEstimator1, GazeEstimator2
    from iris_style_transfer_tpu_torch.ops.image import gray_to_rgb
    from iris_style_transfer_tpu_torch.pipelines import composite_batch, extract_iris_batch

    eff, g1, g2, vgg = _gaze_params()
    with torch.no_grad():
        x = torch.from_numpy(shard_batch(mesh, frames))
        segs = EfficientNet.apply(eff, x)
        pre1 = GazeEstimator1.apply(g1, segs, extract_feature=True)
        pre2 = GazeEstimator2.apply(g2, gray_to_rgb(x), extract_feature=True)
        irises, masks, bboxes = extract_iris_batch(x, segs, 0.8, out_size=(32, 32))
        style = gather_batch(mesh, irises)[:1].expand_as(irises).permute(0, 3, 1, 2)
        res = make_nst_fn(epochs=2, mesh=mesh)(vgg, irises.permute(0, 3, 1, 2), style)
        new_frames = composite_batch(x, res.x.permute(0, 2, 3, 1), masks, bboxes)
        post1 = GazeEstimator1.apply(g1, EfficientNet.apply(eff, new_frames), extract_feature=True)
    return tuple(gather_batch(mesh, t) for t in (new_frames, pre1, pre2, post1))


def _rank_gaze_step(frames):
    return _gaze_step(make_mesh(), frames)


@pytest.mark.slow  # as its JAX counterpart: one jit of B7, ResNet50 and the NST, minutes under the suite's load
def test_sharded_gaze_step_matches_one_rank_and_jax():
    """The 2020 step on 2 ranks against one rank and against JAX's step on
    its 2-device mesh, with ``tests/test_parallel.py:200``'s tolerances: the
    pre-NST predictions are per-sample functions (1e-5 and 2e-4), the rest
    crosses 2 L-BFGS steps (frames: mean 1e-3, max 5e-2; post 2e-2)."""
    import jax
    import jax.numpy as jnp
    from iris_style_transfer_tpu.data.synthetic import synthetic_eye_batch
    from iris_style_transfer_tpu.models import EfficientNet as JEff
    from iris_style_transfer_tpu.models import GazeEstimator1 as JG1
    from iris_style_transfer_tpu.models import GazeEstimator2 as JG2
    from iris_style_transfer_tpu.ops.image import gray_to_rgb as j_gray_to_rgb
    from iris_style_transfer_tpu.parallel import batch_sharding as j_batch_sharding
    from iris_style_transfer_tpu.parallel import make_mesh as j_make_mesh
    from iris_style_transfer_tpu.pipelines import composite_batch as j_composite, extract_iris_batch as j_extract
    from iris_style_transfer_tpu.transfer.nst import make_nst_fn as j_make_nst_fn

    imgs = synthetic_eye_batch(8, height=48, width=64, seed=3)[0].astype(np.float32)
    got = _ranks(functools.partial(_rank_gaze_step, imgs))
    one = _gaze_step(one_rank("cpu"), imgs)

    eff, g1, g2, vgg = (to_jax(p) for p in _gaze_params())
    nst_fn = j_make_nst_fn(epochs=2)

    @jax.jit
    def step(frames):
        segs = JEff.apply(eff, frames)
        pre1 = JG1.apply(g1, segs, extract_feature=True)
        pre2 = JG2.apply(g2, j_gray_to_rgb(frames), extract_feature=True)
        irises, masks, bboxes = j_extract(frames, segs, 0.8, out_size=(32, 32))
        res = nst_fn(vgg, irises, jnp.broadcast_to(irises[:1], irises.shape))
        new_frames = j_composite(frames, res.x, masks, bboxes)
        return new_frames, pre1, pre2, JG1.apply(g1, JEff.apply(eff, new_frames), extract_feature=True)

    want = [np.asarray(t) for t in step(jax.device_put(jnp.asarray(imgs), j_batch_sharding(j_make_mesh(n_devices=2))))]
    for ref in ([t.numpy() for t in one], want):
        np.testing.assert_allclose(got[1].numpy(), ref[1], atol=1e-5)
        np.testing.assert_allclose(got[2].numpy(), ref[2], atol=2e-4)
        df = np.abs(got[0].numpy() - ref[0])
        assert df.mean() < 1e-3 and df.max() < 5e-2, (df.mean(), df.max())
        np.testing.assert_allclose(got[3].numpy(), ref[3], atol=2e-2)
