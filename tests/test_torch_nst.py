"""CPU parity of the torch port's L-BFGS and NST loop against the JAX package.

Tolerances: the compact L-BFGS direction equals the two-loop recursion to
2e-3 of the trajectory's scale (the JAX package's own bound) and the JAX
``lbfgs_step`` on a fixed gradient sequence to 1e-5 of the update's
largest element (float32 dot products summed in another order); ``make_nst_fn``
in float32 at (2, 32, 32, 3), 5 closures, matches the JAX loop's loss
histories to rtol 1e-3, the images of its first closures to atol 1e-4,
and its final image as ``tests/test_nst.py:107-110`` holds its own
variants (mean difference < 1e-4, atol 2e-2).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from iris_style_transfer_tpu.models import VGG19 as JVGG
from iris_style_transfer_tpu.transfer import lbfgs as jlbfgs
from iris_style_transfer_tpu.transfer.nst import make_nst_fn as j_make_nst_fn

from iris_style_transfer_tpu_torch.models import VGG19
from iris_style_transfer_tpu_torch.models.port import from_jax
from iris_style_transfer_tpu_torch.transfer import lbfgs as tlbfgs
from iris_style_transfer_tpu_torch.transfer.nst import cached_nst_program, make_nst_fn


def _problem(n, seed):
    rng = np.random.default_rng(seed)
    m = rng.standard_normal((n, n)).astype(np.float32)
    a = m @ m.T + np.eye(n, dtype=np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    return a, b, rng.standard_normal(n).astype(np.float32)


def _grad(a, b, x):
    return a @ x - b + 0.4 * x**3  # of 0.5 x'Ax - b'x + 0.1 sum(x^4)


def test_compact_equals_two_loop():
    a, b, x0 = _problem(20, 0)
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    traj = {}
    for method in ("compact", "two_loop"):
        x = torch.from_numpy(x0.copy())
        state = tlbfgs.lbfgs_init(20, 6)
        out = []
        for _ in range(25):  # past the history size: the buffer wraps
            out.append(x.numpy().copy())
            upd, state = tlbfgs.lbfgs_step(state, _grad(at, bt, x), 1.0, method=method)
            x = x + upd
        traj[method] = np.asarray(out)
    scale = np.abs(traj["two_loop"]).max()
    np.testing.assert_allclose(traj["compact"], traj["two_loop"], atol=2e-3 * scale)


@pytest.mark.parametrize("history_dtype", ["float32", "bfloat16"])
def test_lbfgs_step_matches_jax_on_fixed_gradients(history_dtype):
    """Open loop: both implementations see the same gradient sequence (a
    JAX trajectory on a quartic, with two gradients perturbed so that pairs
    are rejected) and must produce the same updates."""
    a, b, x0 = _problem(16, 1)
    jdt, tdt = getattr(jnp, history_dtype), getattr(torch, history_dtype)
    shape = (2, 8)  # shape-native state, as the NST loop keeps it
    js = jlbfgs.lbfgs_init(shape, 5, dtype=jdt)
    ts = tlbfgs.lbfgs_init(shape, 5, dtype=tdt)
    x = x0.copy()
    for k in range(14):
        g = _grad(a, b, x).astype(np.float32)
        if k in (4, 9):
            g = -3.0 * g  # y.s < 0: the pair is rejected
        ju, js = jlbfgs.lbfgs_step(js, jnp.asarray(g.reshape(shape)), 1.0)
        tu, ts = tlbfgs.lbfgs_step(ts, torch.from_numpy(g.reshape(shape)), 1.0)
        np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=1e-5, atol=1e-5 * np.abs(ju).max())
        assert int(ts.count) == int(js.count)
        x = x + np.asarray(ju).reshape(-1)
    assert 0 < int(ts.count) < 14  # both accepted and rejected pairs occurred


def test_compact_bf16_near_cancelling_pair_stays_finite():
    """An accepted pair whose bf16-rounded y.s is 0 must not make the
    triangular solve singular (the diagonal comes from the f32 y.s)."""
    state = tlbfgs.lbfgs_init(4, 3, dtype=torch.bfloat16)
    s = torch.tensor([1.0, -1.0 + 1e-4, 0.0, 0.0])
    state = state._replace(prev_g=torch.zeros(4), prev_step=s, iteration=1)
    upd, state = tlbfgs.lbfgs_step(state, torch.tensor([1.0, 1.0, 0.0, 0.0]))
    assert torch.isfinite(upd).all() and int(state.count) == 1
    upd2, _ = tlbfgs.lbfgs_step(state, torch.tensor([0.5, -0.3, 0.2, 0.1]))
    assert torch.isfinite(upd2).all()


@pytest.fixture(scope="module")
def vgg_and_images():
    jp = jax.tree.map(np.asarray, jax.jit(JVGG.init)(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    c = rng.random((2, 32, 32, 3)).astype(np.float32)
    s = rng.random((2, 32, 32, 3)).astype(np.float32)
    return jp, from_jax(jp), c, s


def _nchw(a):
    return torch.from_numpy(a).permute(0, 3, 1, 2)


@pytest.mark.parametrize("variant", [
    {"history_every": 1},
    {"bn_loss": False},
    {"optimizer": "adam", "lr": 0.02, "history_every": 2, "epochs": 6},
])
def test_make_nst_fn_matches_jax(vgg_and_images, variant):
    jp, tp, c, s = vgg_and_images
    variant = {"epochs": 5, **variant}
    want = jax.jit(j_make_nst_fn(**variant))(jp, jnp.asarray(c), jnp.asarray(s))
    got = make_nst_fn(**variant)(tp, _nchw(c), _nchw(s))
    np.testing.assert_allclose(got.s_loss_hist.numpy(), np.asarray(want.s_loss_hist), rtol=1e-3)
    np.testing.assert_allclose(got.c_loss_hist.numpy(), np.asarray(want.c_loss_hist), rtol=1e-3, atol=1e-10)
    # L-BFGS amplifies float32 reassociation noise: after a few closures
    # isolated pixels land on the other side of a relu/clip tie, so the
    # final image is held as tests/test_nst.py holds its variants (the field
    # as a whole agrees), and the first closures' images to atol 1e-4
    x, x_j = got.x.permute(0, 2, 3, 1).numpy(), np.asarray(want.x)
    assert np.mean(np.abs(x - x_j)) < 1e-4
    np.testing.assert_allclose(x, x_j, atol=2e-2)
    assert float(got.x.min()) >= 0.0 and float(got.x.max()) <= 1.0
    if variant.get("history_every"):
        n = variant["epochs"] // variant["history_every"]
        assert got.x_hist.shape == (n, 2, 3, 32, 32)
        snaps, snaps_j = got.x_hist.permute(0, 1, 3, 4, 2).numpy(), np.asarray(want.x_hist)
        np.testing.assert_allclose(snaps[:3], snaps_j[:3], atol=1e-4)
        np.testing.assert_allclose(snaps, snaps_j, atol=2e-2)


def test_noise_init_is_seeded_and_production_program_is_cached(vgg_and_images):
    _, tp, c, s = vgg_and_images
    fn = make_nst_fn(epochs=2, clone_content=False)
    r1 = fn(tp, _nchw(c), _nchw(s), torch.Generator().manual_seed(7))
    r2 = fn(tp, _nchw(c), _nchw(s), torch.Generator().manual_seed(7))
    assert float(r1.c_loss_hist[0]) > 0.0  # noise init: nonzero content loss
    assert torch.equal(r1.x, r2.x)
    assert cached_nst_program(3, 1.0, 1.0, "bfloat16") is cached_nst_program(3, 1.0, 1.0, "bfloat16")
    res = cached_nst_program(3, 1.0, 1.0, "bfloat16")(tp, _nchw(c), _nchw(s))
    assert res.s_loss_hist.shape == (3,) and torch.isfinite(res.s_loss_hist).all()
    assert float(res.c_loss_hist[0]) == 0.0  # the first closure evaluates the content image


def test_vgg_stats_taps_match_jax(vgg_and_images):
    """Style entries as (mean, std) pairs from the fused relu+stats tap,
    against JAX's ``VGG19.apply(stats_taps=True)`` (rtol 1e-4, as the taps
    themselves), and the ineligible layer set raises in both."""
    jp, tp, c, _ = vgg_and_images
    _, cj, sj = jax.jit(lambda p, x: JVGG.apply(p, x, truncate=True, stats_taps=True))(jp, jnp.asarray(c))
    _, ct, st = VGG19.apply(tp, _nchw(c), truncate=True, stats_taps=True)
    np.testing.assert_allclose(ct[0].permute(0, 2, 3, 1).numpy(), np.asarray(cj[0]), rtol=1e-4,
                               atol=1e-4 * np.abs(cj[0]).max())
    for (m, s), (mj, sj_) in zip(st, sj):
        assert m.shape == mj.shape and m.dtype == torch.float32
        np.testing.assert_allclose(m.numpy(), np.asarray(mj), rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(s.numpy(), np.asarray(sj_), rtol=1e-4, atol=1e-6)
    for apply, params, x in ((VGG19.apply, tp, _nchw(c)), (JVGG.apply, jp, jnp.asarray(c))):
        with pytest.raises(ValueError, match="stats_taps"):
            apply(params, x, content_layers=("relu2_1",), style_layers=("relu1_1", "relu2_1"), stats_taps=True)
        with pytest.raises(ValueError, match="stats_taps"):
            apply(params, x, style_layers=("conv1_1",), stats_taps=True)


def test_stats_taps_nst_matches_jax_and_the_classic_path(vgg_and_images):
    """``make_nst_fn(stats_taps=True)`` against JAX's for 6 closures, with
    the images held after 5 as the other variants are (the classic path
    drifts from JAX as far in the sixth: L-BFGS amplification, not the
    taps); and against the port's own classic BN path to rtol 1e-4 and a
    mean image difference under 1e-5, as ``tests/test_nst.py:137-155``
    holds JAX's.  An ineligible layer set silently runs the classic path."""
    jp, tp, c, s = vgg_and_images
    for epochs in (5, 6):
        want = jax.jit(j_make_nst_fn(epochs=epochs, stats_taps=True))(jp, jnp.asarray(c), jnp.asarray(s))
        got = make_nst_fn(epochs=epochs, stats_taps=True)(tp, _nchw(c), _nchw(s))
        np.testing.assert_allclose(got.s_loss_hist.numpy(), np.asarray(want.s_loss_hist), rtol=1e-3)
        np.testing.assert_allclose(got.c_loss_hist.numpy(), np.asarray(want.c_loss_hist), rtol=1e-3, atol=1e-10)
        x, x_j = got.x.permute(0, 2, 3, 1).numpy(), np.asarray(want.x)
        assert np.mean(np.abs(x - x_j)) < (1e-4 if epochs == 5 else 2e-4)
        np.testing.assert_allclose(x, x_j, atol=2e-2)
    classic = make_nst_fn(epochs=6)(tp, _nchw(c), _nchw(s))
    np.testing.assert_allclose(got.s_loss_hist.numpy(), classic.s_loss_hist.numpy(), rtol=1e-4)
    np.testing.assert_allclose(got.c_loss_hist.numpy(), classic.c_loss_hist.numpy(), rtol=1e-4, atol=1e-10)
    assert torch.mean(torch.abs(got.x - classic.x)) < 1e-5
    mixed = dict(epochs=2, content_layers=("relu4_1",))
    torch.testing.assert_close(make_nst_fn(stats_taps=True, **mixed)(tp, _nchw(c), _nchw(s)).s_loss_hist,
                               make_nst_fn(**mixed)(tp, _nchw(c), _nchw(s)).s_loss_hist, rtol=0, atol=0)


@pytest.mark.parametrize("bn_loss", [True, False])
def test_nst_wrapper_matches_jax_and_is_cached(vgg_and_images, bn_loss):
    from iris_style_transfer_tpu.transfer.nst import nst as j_nst
    from iris_style_transfer_tpu_torch.transfer.nst import _cached_nst_fn, nst

    jp, tp, c, s = vgg_and_images
    kw = dict(BN_loss=bn_loss, c_loss_weight=0.0, s_loss_weight=1.0, epochs=4, history_every=2)
    want = j_nst(jnp.asarray(c), jnp.asarray(s), jp, **kw)
    got = nst(_nchw(c), _nchw(s), tp, **kw)
    np.testing.assert_allclose(got.s_loss_hist.numpy(), np.asarray(want.s_loss_hist), rtol=1e-3)
    assert got.x_hist.shape == (2, 2, 3, 32, 32)
    np.testing.assert_allclose(got.x.permute(0, 2, 3, 1).numpy(), np.asarray(want.x), atol=2e-2)
    hits = _cached_nst_fn.cache_info().hits
    nst(_nchw(c), _nchw(s), tp, **kw)
    assert _cached_nst_fn.cache_info().hits == hits + 1


def test_production_program_takes_the_stats_taps_flag(vgg_and_images):
    _, tp, c, s = vgg_and_images
    assert cached_nst_program(2, 1.0, 1.0, "float32", 10, "auto") is cached_nst_program(2, 1.0, 1.0, "float32")
    on = cached_nst_program(2, 1.0, 1.0, "float32", 10, "on")
    assert on is not cached_nst_program(2, 1.0, 1.0, "float32")
    np.testing.assert_allclose(on(tp, _nchw(c), _nchw(s)).s_loss_hist.numpy(),
                               cached_nst_program(2, 1.0, 1.0, "float32")(tp, _nchw(c), _nchw(s)).s_loss_hist.numpy(),
                               rtol=1e-4)
    with pytest.raises(ValueError, match="stats_taps"):
        cached_nst_program(2, 1.0, 1.0, "float32", 10, "yes")
