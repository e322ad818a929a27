"""The compact L-BFGS step's passes (``ops/lbfgs.py``) and the SY and YY
that the step carries (``transfer/lbfgs.py``).

CPU (tier 1), with m = 10 and bf16 and float32 history, over 35 steps
(three times through the buffer) with three forced rejections and a
channels_last gradient, as the VGG stack hands it over: the carried SY and
YY equal a float64 recompute from the buffers to 2^-23 of ``|S| |Y|'``
(the plain dots are float64 sums rounded once); the updates equal the
two-loop recursion's from the same state (float32 history: 1e-4 of the
update's L2 norm; bf16: 2^-6, the bf16 rounding of the compact form's
coefficients, which the two-loop does not round), and, with float32
history, JAX's ``lbfgs_step`` on the same gradients (rtol 1e-5, as
``tests/test_torch_nst.py`` holds m = 5).  The kernels' launch plan at the IST mains' shapes, and their index
math and float32 summation order emulated in numpy at small shapes: every
element read once, every sum within ``sum_depth`` of float64.  The
kernels themselves are held on the card in ``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from iris_style_transfer_tpu.transfer import lbfgs as jlbfgs

from iris_style_transfer_tpu_torch.ops import lbfgs as L
from iris_style_transfer_tpu_torch.transfer import lbfgs as tlbfgs

M = 10
STEPS = 35
FLIPS = (7, 18, 29)  # y.s < 0 at these steps: the pair is rejected
SHAPE = (2, 3, 4, 5)  # NCHW, channels_last memory
DTYPES = [torch.float32, torch.bfloat16]


def _quartic(seed=0):
    rng = np.random.default_rng(seed)
    n = int(np.prod(SHAPE))
    a = rng.standard_normal((n, n)).astype(np.float32) / np.sqrt(n)
    a = (a @ a.T + np.eye(n)).astype(np.float32)
    return torch.from_numpy(a), torch.from_numpy(rng.standard_normal(n).astype(np.float32)), \
        torch.from_numpy(rng.standard_normal(n).astype(np.float32))


def _gradient(a, b, x, k):
    """The gradient of 0.5 x'Ax - b'x + 0.1 sum(x^4) at x (flat), flipped at
    FLIPS, as a channels_last (N, C, H, W) tensor."""
    g = a @ x - b + 0.4 * x**3
    g = -3.0 * g if k in FLIPS else g
    return g.reshape(SHAPE).contiguous(memory_format=torch.channels_last)


def _clone(state):
    return state._replace(**{k: v.clone() for k, v in state._asdict().items() if torch.is_tensor(v)})


@pytest.mark.parametrize("dtype", DTYPES)
def test_carried_sy_yy_equal_a_full_recompute(dtype):
    a, b, x = _quartic()
    state = tlbfgs.lbfgs_init(SHAPE, M, dtype=dtype)
    for k in range(STEPS):
        g = _gradient(a, b, x, k)
        upd, state = tlbfgs.lbfgs_step(state, g)
        S, Y = state.s_hist.reshape(M, -1).double(), state.y_hist.reshape(M, -1).double()
        for got, want, scale in ((state.SY, S @ Y.T, S.abs() @ Y.abs().T), (state.YY, Y @ Y.T, Y.abs() @ Y.abs().T)):
            assert ((got.double() - want).abs() <= 2.0**-23 * scale).all(), k
        x = x + upd.reshape(-1)
    assert state.s_hist[0].stride() == g.stride()  # the history took the gradient's memory order
    assert 2 * M < int(state.count) < STEPS - 1  # the buffer wrapped; pairs were refused


@pytest.mark.parametrize("dtype", DTYPES)
def test_updates_match_the_two_loop_from_the_same_state(dtype):
    a, b, x = _quartic(1)
    state = tlbfgs.lbfgs_init(SHAPE, M, dtype=dtype)
    tol = 1e-4 if dtype == torch.float32 else 2.0**-6
    for k in range(STEPS):
        g = _gradient(a, b, x, k)
        want, _ = tlbfgs.lbfgs_step(_clone(state), g, method="two_loop")
        upd, state = tlbfgs.lbfgs_step(state, g)
        assert ((upd - want).norm() / want.norm()).item() <= tol, k
        x = x + upd.reshape(-1)


def test_updates_match_jax_over_three_histories():
    """Open loop: both see a JAX trajectory's gradients (flipped at FLIPS).
    Float32 history: with bf16 the parent's port parts from JAX by up to
    1.4% from the first wrap on (one coefficient's bf16 rounding falls the
    other way), and so does this one, to the same digits."""
    a, b, x = (t.numpy() for t in _quartic(2))
    js = jlbfgs.lbfgs_init(SHAPE, M)
    ts = tlbfgs.lbfgs_init(SHAPE, M)
    for k in range(STEPS):
        g = _gradient(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(x), k)
        ju, js = jlbfgs.lbfgs_step(js, jnp.asarray(g.numpy()), 1.0)
        tu, ts = tlbfgs.lbfgs_step(ts, g, 1.0)
        np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=1e-5, atol=1e-5 * np.abs(ju).max())
        assert int(ts.count) == int(js.count)
        x = x + np.asarray(ju).reshape(-1)
    assert int(ts.count) > 2 * M


def test_the_cpu_path_launches_nothing_and_the_kernels_refuse_cpu_tensors():
    assert L.passes(torch.device("cpu")) is L.PLAIN and L.passes(torch.device("cuda")) is L.KERNELS
    with pytest.raises(ValueError, match="unsupported device"):
        L.passes(torch.device("meta"))
    before = dict(L.LAUNCHES)
    a, b, x = _quartic()
    state = tlbfgs.lbfgs_init(SHAPE, M, dtype=torch.bfloat16)
    for k in range(3):
        upd, state = tlbfgs.lbfgs_step(state, _gradient(a, b, x, k))
        x = x + upd.reshape(-1)
    assert L.LAUNCHES == before
    g = torch.zeros(SHAPE)
    with pytest.raises(ValueError, match="CUDA"):
        L._kernel_pair(g, g, g)


def test_a_contiguous_gradient_keeps_the_history_as_it_is():
    state = tlbfgs.lbfgs_init(SHAPE, 3)
    s_hist = state.s_hist
    _, state = tlbfgs.lbfgs_step(state, torch.ones(SHAPE))
    assert state.s_hist is s_hist and state.iteration == 1


# the IST mains' NST images: 2019 at bs 64, 2020 at bs 128
MAIN_N = (64 * 3 * 224 * 224, 128 * 3 * 224 * 224)


@pytest.mark.parametrize("n", MAIN_N)
def test_plan_at_the_main_shapes(n):
    pl = L.plan(n, M, torch.bfloat16)
    assert pl == L.Plan(vec=8, blocks=L.PARTIAL_BLOCKS, chunks=1, dir_blocks=-(-n // (8 * L.THREADS)))
    assert L.plan(n, 1, torch.float32).vec == 4
    # every thread's sum is short enough that the stated bound stays near float32's own rounding
    assert L.sum_depth(n, pl) < 2048


@pytest.mark.parametrize("m,chunks", [(1, 1), (5, 1), (10, 1), (16, 2), (17, 2), (40, 4)])
def test_plan_splits_the_rows(m, chunks):
    pl = L.plan(1000, m, torch.bfloat16)
    assert pl.chunks == chunks
    # the dots kernel's chunk c: rows r0 = c * ROWS up to min(ROWS, m - r0) of them; each row in one chunk
    held = [r for c in range(pl.chunks) for r in range(c * L.ROWS, c * L.ROWS + min(L.ROWS, m - c * L.ROWS))]
    assert held == list(range(m))


def test_plan_falls_back_to_one_element_a_load():
    assert L.plan(1001, M, torch.bfloat16).vec == 1  # N off the vector
    assert L.plan(1000, M, torch.bfloat16, aligned=False).vec == 1
    assert L.plan(1004, M, torch.bfloat16).vec == 1 and L.plan(1004, M, torch.float32).vec == 4
    assert L.plan(7, M, torch.float32) == L.Plan(vec=1, blocks=1, chunks=1, dir_blocks=1)


def _butterfly(v):
    """The kernels' warp sum: ``v`` (..., 32) float32, lane l adding lane
    l ^ o for o = 16, 8, 4, 2, 1; every lane ends with the same sum."""
    lanes = np.arange(32)
    for o in (16, 8, 4, 2, 1):
        v = (v + v[..., lanes ^ o]).astype(np.float32)
    return v[..., 0]


def _emulate_sum(terms, pl):
    """One sum of the pair or dots pass in the kernels' order: ``terms``
    (N,) float32 products; block b's thread t adds elements of vectors i =
    b * 256 + t, + blocks * 256, ... in order; the warp's butterfly, the
    block's warps in order, then the reduce: lane l adds blocks l, l + 32,
    ... in order, and the butterfly.  Also returns how often each element
    was read."""
    n, threads = terms.shape[0], L.THREADS
    nv, stride = n // pl.vec, pl.blocks * threads
    acc = np.zeros((pl.blocks, threads), np.float32)
    reads = np.zeros(n, np.int64)
    for start in range(0, nv, stride):
        i = start + np.arange(stride)
        live = i < nv
        for k in range(pl.vec):
            e = i[live] * pl.vec + k
            flat = acc.reshape(-1)
            flat[live] = (flat[live] + terms[e]).astype(np.float32)
            reads[e] += 1
    warps = _butterfly(acc.reshape(pl.blocks, threads // 32, 32))
    block = warps[:, 0].copy()
    for w in range(1, threads // 32):
        block = (block + warps[:, w]).astype(np.float32)
    lanes = np.zeros(32, np.float32)
    for b in range(pl.blocks):
        lanes[b % 32] = np.float32(lanes[b % 32] + block[b])
    return _butterfly(lanes), reads


@pytest.mark.parametrize("n,dtype,aligned", [(8 * 256 * 264 * 2 + 8 * 77, torch.bfloat16, True),
                                             (4 * 256 * 3 + 4, torch.float32, True),
                                             (3 * 256 + 5, torch.bfloat16, False), (9, torch.float32, True)])
def test_kernel_sum_order_reads_every_element_once_within_the_bound(n, dtype, aligned):
    pl = L.plan(n, M, dtype, aligned)
    rng = np.random.default_rng(n)
    # bf16 x bf16 products, exact in float32, as the dots pass forms them
    a = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(torch.bfloat16).float().numpy()
    b = torch.from_numpy(rng.standard_normal(n).astype(np.float32) + 0.3).to(torch.bfloat16).float().numpy()
    terms = (a * b).astype(np.float32)
    got, reads = _emulate_sum(terms, pl)
    assert (reads == 1).all()
    ok, _ = L.within_sum_bound(torch.tensor([float(got)]), torch.from_numpy(terms)[None], L.sum_depth(n, pl))
    assert ok


def test_direction_plain_follows_the_formula():
    gen = torch.Generator().manual_seed(3)
    S, Y = torch.randn((M, *SHAPE), generator=gen).bfloat16(), torch.randn((M, *SHAPE), generator=gen).bfloat16()
    g, top, bot = torch.randn(SHAPE, generator=gen), torch.randn(M, generator=gen), torch.randn(M, generator=gen)
    gamma = torch.tensor(0.7)
    want = 0.5 * -(gamma.double() * g.double() + torch.einsum("j,j...->...", top.double(), S.double())
                   + gamma.double() * torch.einsum("j,j...->...", bot.double(), Y.double()))
    got = L.direction_plain(S, Y, g, top, bot, gamma, 0.5)
    assert torch.allclose(got.double(), want, rtol=1e-5, atol=1e-5 * want.abs().max().item())
