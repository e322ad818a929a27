"""Spatial sharding (``parallel/mesh.py``: ``spatial_sharding``, ``halo_rows``)
on the CPU: images split on H over the model group of gloo ranks.

Ranks are spawned by ``run_ranks``, each join bounded by :data:`JOIN_S`;
JAX is imported inside the tests only (the spawned ranks import this
module to find their functions, and they run no JAX).  Inputs are made with
numpy from a seed at (2, 3, 32, 32), on seeded VGG19 weights truncated at
relu4_2, in float32.  Tolerances:

  * a 3x3 conv on the haloed slab (the plain conv and the conv1_1 path)
    against the whole image's conv, forward and input gradient, on 2 and
    4 ranks: 1e-6 of the output's (gradient's) largest magnitude; the two
    differ only where a halo row's gradient is added in another order;
  * VGG19's taps on each slab (classic tensors, and the stats taps' whole
    image (mean, std)) and the NST loss gradient on each slab against the
    one-rank rows: 1e-5 of each tensor's largest magnitude;
  * the NST on (data 1, model 2) and (data 2, model 2) against one rank,
    3 closures (the classic BN loss from the content and from a noise
    init, the stats taps, the Gram loss): the losses of closures 0 and 1
    rtol 1e-5 and the image after the first step atol 1e-6; closure 2 is
    the first after L-BFGS's first curvature pair, a difference of two
    nearly equal gradients, and on these inputs the data split alone
    (no model group) moves its style loss by 1.6e-2, so it and the final
    image are held as JAX's sharded tests hold theirs (rtol 2e-2; mean
    |dx| < 1e-3, max |dx| < 5e-2; ROADMAP, "Found in the reference");
  * the NST on (data 1, model 2) against JAX's ``make_nst_fn`` on
    ``spatial_sharding(make_mesh(n_devices=2, model_parallel=2))``, 5
    closures, with JAX's own tolerance (``tests/test_parallel.py:69-103``):
    rtol 2e-2 on ``s_loss_hist``, mean |dx| < 1e-3, max |dx| < 5e-2.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import pytest
import torch

from iris_style_transfer_tpu_torch.models import VGG19
from iris_style_transfer_tpu_torch.models import layers as L
from iris_style_transfer_tpu_torch.models.port import to_jax
from iris_style_transfer_tpu_torch.ops import conv1
from iris_style_transfer_tpu_torch.ops.losses import content_loss_l2, style_loss_bn_stats, style_stats
from iris_style_transfer_tpu_torch.ops.losses import style_stats_split
from iris_style_transfer_tpu_torch.parallel import (
    gather_batch,
    gather_height,
    halo_rows,
    height_sharding,
    make_mesh,
    one_rank,
    run_ranks,
    shard_batch,
    spatial_sharding,
)
from iris_style_transfer_tpu_torch.transfer.nst import make_nst_fn

JOIN_S = 120  # every spawned run fails after this many seconds
SHAPE = (2, 3, 32, 32)
CLOSURES = 3


def _ranks(fn, n: int):
    return run_ranks(fn, n, devices=["cpu"] * n, timeout=JOIN_S)


def _images(seed=0, shape=SHAPE):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.random(shape, dtype=np.float32)) for _ in range(2))


def _vgg():
    return VGG19.init(torch.Generator().manual_seed(0))


def _close(got: torch.Tensor, want: torch.Tensor, rel: float, what: str) -> None:
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(), rtol=0,
                               atol=rel * want.abs().max().item(), err_msg=what)


# ---------------------------------------------------------------------------
# the halo exchange
# ---------------------------------------------------------------------------


def _convs(x, mesh):
    """conv1_1's path (the small-C_in op on the haloed rows, rows 1..h
    kept) and a plain 3x3 conv (W padded only) on ``x``, the whole image
    or this rank's slab of it."""
    gen = torch.Generator().manual_seed(1)
    p1, p2 = L.init_conv(gen, 3, 3, 3, 8), L.init_conv(gen, 3, 3, 3, 8)
    if mesh is None:
        return conv1.conv1(x, p1), L.conv2d(x, p2, padding=1)
    return conv1.conv1(halo_rows(x, mesh), p1)[:, :, 1:-1], L.conv2d(halo_rows(x, mesh), p2, padding=(0, 1))


def _conv_outputs(x, mesh):
    """The two convs and the input gradient of a fixed random weighting of
    their outputs, gathered whole."""
    x = x.clone().requires_grad_(True)
    outs = _convs(x, mesh)
    w = _images(5, (SHAPE[0], 8, SHAPE[2], SHAPE[3]))
    rows = slice(None) if mesh is None else height_sharding(mesh, SHAPE[2])
    loss = sum((y * wi[:, :, rows]).sum() for y, wi in zip(outs, w))
    (gx,) = torch.autograd.grad(loss, x)
    whole = (lambda t: t) if mesh is None else functools.partial(gather_height, mesh)
    return [whole(t.detach()) for t in (*outs, gx)]


def _rank_convs(n):
    mesh = make_mesh(model_parallel=n)
    x = _images()[0]
    return _conv_outputs(x[spatial_sharding(mesh, x.shape)], mesh)


@pytest.mark.parametrize("n", [2, 4])
def test_haloed_conv_equals_the_whole_image(n):
    """The slab's rows of both convs and of the input gradient, the
    borrowed rows' gradients sent home: rank 0 of ``n`` gathers each whole."""
    got = _ranks(functools.partial(_rank_convs, n), n)
    want = _conv_outputs(_images()[0], None)
    for g, w, what in zip(got, want, ("conv1_1 path", "plain conv", "input gradient")):
        _close(g, w, 1e-6, what)


def test_one_model_rank_is_the_identity_and_odd_splits_raise():
    mesh = make_mesh()
    x = torch.ones(1, 2, 4, 3)
    assert halo_rows(x, mesh) is x and gather_height(mesh, x) is x  # no halo, no collective
    assert height_sharding(mesh, 20) == slice(0, 20)
    two = dataclasses.replace(mesh, shape={"data": 1, "model": 2})
    assert height_sharding(two, 224) == slice(0, 112)
    with pytest.raises(ValueError, match="H=40 .*model=2"):
        height_sharding(two, 40)  # 40 / 8 = 5 rows at relu4_1


# ---------------------------------------------------------------------------
# VGG19 and the NST loss on slabs
# ---------------------------------------------------------------------------


def _vgg_and_grad(mesh, c, s):
    """Both tap kinds of ``c`` and the gradient of the NST's loss at ``c``
    (content targets of ``c`` shifted, style targets of ``s``), each
    gathered whole; ``mesh`` None is one rank on whole images.  The loss is
    ``make_nst_fn``'s: the content mean's share and the style loss from
    the whole image's statistics."""
    m = 1 if mesh is None else mesh.shape["model"]
    vgg_mesh = mesh if m > 1 else None
    stats = (lambda fs: [style_stats(f) for f in fs]) if m == 1 else \
        (lambda fs: style_stats_split(fs, mesh.model_group, m))
    params = _vgg()
    final, content, style = VGG19.apply(params, c, truncate=True, mesh=vgg_mesh)
    _, _, stats_taps = VGG19.apply(params, c, truncate=True, stats_taps=True, mesh=vgg_mesh)
    _, c_t, _ = VGG19.apply(params, 0.5 * c, truncate=True, mesh=vgg_mesh)
    _, _, s_f = VGG19.apply(params, s, truncate=True, mesh=vgg_mesh)
    s_t = stats(s_f)
    x = c.clone().requires_grad_(True)
    _, x_c, x_s = VGG19.apply(params, x, truncate=True, mesh=vgg_mesh)
    shares = 1 if mesh is None else mesh.world_size
    loss = content_loss_l2(x_c, c_t) / shares + style_loss_bn_stats(stats(x_s), s_t)
    (gx,) = torch.autograd.grad(loss, x)
    whole = (lambda t: t) if m == 1 else functools.partial(gather_height, mesh)
    tensors = [whole(t.detach()) for t in (final, *content, *style, gx)]
    return tensors, [t for pair in stats_taps for t in pair], [t for pair in stats(style) for t in pair]


def _rank_vgg():
    mesh = make_mesh(model_parallel=2)
    c, s = (t[spatial_sharding(mesh, t.shape)] for t in _images())
    return _vgg_and_grad(mesh, c, s)


def test_vgg19_taps_and_nst_gradient_on_slabs_equal_one_rank():
    got = _ranks(_rank_vgg, 2)
    want = _vgg_and_grad(None, *_images())
    names = ["final", "relu4_2", "relu1_1", "relu2_1", "relu3_1", "relu4_1", "loss gradient"]
    for g, w, what in zip(got[0], want[0], names):
        _close(g, w, 1e-5, what)
    for k in (1, 2):  # the stats taps, and the classic taps' statistics from the slabs' sums
        for i, (g, w) in enumerate(zip(got[k], want[k])):
            _close(g, w, 1e-5, f"stats {k}, tap {i // 2}, {'std' if i % 2 else 'mean'}")


# ---------------------------------------------------------------------------
# the NST on a model group
# ---------------------------------------------------------------------------

# closures before L-BFGS takes its first curvature pair: the pair is the
# difference of two nearly equal gradients (the first step is 1/|g|_1), so
# from closure 2 on any other summation order moves the trajectory; on
# these inputs the data split alone moves closure 2's style loss by 1.6e-2
PAIR_FREE = 2
NST_VARIANTS = {  # name: make_nst_fn's flags
    "bn": {},
    "bn_noise": {"clone_content": False, "history_every": 1},
    "stats_taps": {"stats_taps": True},
    "gram": {"bn_loss": False, "s_loss_weight": 1e4},
}


def _nst_runs(mesh, epochs=CLOSURES, variants=tuple(NST_VARIANTS)):
    c, s = _images(3)
    if mesh is not None:
        c, s = (t[spatial_sharding(mesh, t.shape)] for t in (c, s))
    out = {}
    for name in variants:
        gen = torch.Generator().manual_seed(7)
        res = make_nst_fn(epochs=epochs, mesh=mesh, **NST_VARIANTS[name])(_vgg(), c, s, gen, gather=True)
        out[name] = res
    return out


def _rank_nst(n_data, epochs=CLOSURES, variants=tuple(NST_VARIANTS)):
    mesh = make_mesh(model_parallel=2)
    assert mesh.shape == {"data": n_data, "model": 2}
    return _nst_runs(mesh, epochs, variants)


def assert_nst_equal(got: dict, want: dict) -> None:
    """Each variant's NST (``got``) against one rank's (``want``): closures
    0 and 1, which precede L-BFGS's first curvature pair, and the image
    after the first step, to rtol 1e-5; closure 2, the first after it, to
    rtol 2e-2 and the final image as JAX's sharded tests hold theirs."""
    for name, w in want.items():
        g = got[name]
        k = PAIR_FREE
        np.testing.assert_allclose(g.s_loss_hist[:k].numpy(), w.s_loss_hist[:k].numpy(), rtol=1e-5, err_msg=name)
        np.testing.assert_allclose(g.c_loss_hist[:k].numpy(), w.c_loss_hist[:k].numpy(), rtol=1e-5, atol=1e-12,
                                   err_msg=name)
        np.testing.assert_allclose(g.s_loss_hist.numpy(), w.s_loss_hist.numpy(), rtol=2e-2, err_msg=name)
        dx = (g.x - w.x).abs()
        assert dx.mean() < 1e-3 and dx.max() < 5e-2, (name, dx.mean().item(), dx.max().item())
        if w.x_hist is not None:  # the noise init is the whole batch's draw, cut to each rank's block
            torch.testing.assert_close(g.x_hist[0], w.x_hist[0], rtol=0, atol=0)
            np.testing.assert_allclose(g.x_hist[1].numpy(), w.x_hist[1].numpy(), rtol=0, atol=1e-6, err_msg=name)


@pytest.fixture(scope="module")
def one_rank_nst():
    return _nst_runs(None)


@pytest.mark.parametrize("n_data", [1, 2], ids=["data1_model2", "data2_model2"])
def test_nst_on_a_model_group_equals_one_rank(n_data, one_rank_nst):
    got = _ranks(functools.partial(_rank_nst, n_data), 2 * n_data)
    assert_nst_equal(got, one_rank_nst)


def test_spatial_nst_holds_jax_spatial_sharding():
    import jax
    from iris_style_transfer_tpu.parallel import make_mesh as j_make_mesh
    from iris_style_transfer_tpu.parallel import shard_params as j_shard_params
    from iris_style_transfer_tpu.parallel import spatial_sharding as j_spatial_sharding
    from iris_style_transfer_tpu.transfer.nst import make_nst_fn as j_make_nst_fn

    got = _ranks(functools.partial(_rank_nst, 1, 5, ("bn",)), 2)["bn"]
    jmesh = j_make_mesh(n_devices=2, model_parallel=2)
    sp = j_spatial_sharding(jmesh)
    c, s = (t.permute(0, 2, 3, 1).numpy() for t in _images(3))
    want = jax.jit(j_make_nst_fn(epochs=5))(j_shard_params(jmesh, to_jax(_vgg())), jax.device_put(c, sp),
                                            jax.device_put(s, sp))
    np.testing.assert_allclose(got.s_loss_hist.numpy(), np.asarray(want.s_loss_hist), rtol=2e-2)
    dx = np.abs(got.x.numpy() - np.asarray(want.x).transpose(0, 3, 1, 2))
    assert dx.mean() < 1e-3 and dx.max() < 5e-2, (dx.mean(), dx.max())
