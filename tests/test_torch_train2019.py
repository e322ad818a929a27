"""CPU parity of the port's classifier-training slice against the JAX
package: batching, the warps, ``build_ir_dataset``, dropout, the training
step with Adam, and the checkpoint format.

Tolerances: batching exact; the bilinear perspective warp 1e-5; the
nearest rotation >= 99.5% equal pixels (a source coordinate within
rounding of .5 may round the other way in another float order); the
classifier crops of ``build_ir_dataset`` with equal labels and >= 97% of
their u16 pixels within one level (RITnet labels agree >= 99.5% between the
eager port and the jitted JAX graph, ROADMAP section 3, and a flipped pixel
on the iris border moves the crop box); dropout's keep share within 3 sigma
of its binomial mean.

The training step: the first step's gradients within ``1e-4 * max|g|`` of
JAX per parameter leaf (measured: 3.2e-6), and on the same gradients
``torch.optim.Adam``'s updates within ``1e-5`` of ``optax.adam``'s and
``1e-6`` of an f64 Adam, relative to the largest update.  After two steps
end to end, each leaf is within ``1e-4`` of ``optax`` in norm (measured:
7.5e-5), not the ``1e-5`` of the updates alone: Adam's first step moves
every element by ``lr * g / (|g| + eps)``, so an element whose gradient is
zero to within rounding (a relu output just above 0 feeding it) can move
by ``lr`` either way, and the elementwise difference reaches 5% of
``max|p|`` on a few elements.
"""

import os

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from iris_style_transfer_tpu.data.openeds2019 import build_ir_dataset as j_build_ir_dataset
from iris_style_transfer_tpu.data.prefetch import batch_iterator as j_batch_iterator
from iris_style_transfer_tpu.models import Classifier1 as JC1
from iris_style_transfer_tpu.models import Classifier2 as JC2
from iris_style_transfer_tpu.models import RITnet as JRITnet
from iris_style_transfer_tpu.models import VGG19 as JVGG
from iris_style_transfer_tpu.ops import image as jimg
from iris_style_transfer_tpu.ops.metrics import cross_entropy as j_cross_entropy
from iris_style_transfer_tpu.runtime.checkpoint import restore_checkpoint as j_restore_checkpoint

from iris_style_transfer_tpu_torch.data import batch_iterator, build_ir_dataset, prefetch_to_device
from iris_style_transfer_tpu_torch.data.synthetic import synthetic_openeds2019
from iris_style_transfer_tpu_torch.models import Classifier1, Classifier2, RITnet, VGG19
from iris_style_transfer_tpu_torch.models import layers as tl
from iris_style_transfer_tpu_torch.models.port import from_jax, to_jax
from iris_style_transfer_tpu_torch.ops import image as timg
from iris_style_transfer_tpu_torch.runtime import checkpoint as tckpt
from iris_style_transfer_tpu_torch.workloads import iris_classification as wl
from iris_style_transfer_tpu_torch.workloads import ist_openeds2019 as ist

# divisible through RITnet's four 2x2 pools and CLAHE's 8x8 grid; the
# bundled RITnet labels every pixel of a 48x64 twin frame background, which
# would leave the iris crops empty, so the crops are taken at 208x320
H, W = 208, 320
NUM_CLASS = 5


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("shuffle,drop,pad", [(False, False, True), (True, True, True), (True, False, True),
                                              (True, False, False)])
def test_batch_iterator_matches_jax(shuffle, drop, pad):
    a = np.arange(23 * 2).reshape(23, 2)
    b = np.arange(23) * 10
    kw = dict(shuffle=shuffle, seed=7, drop_remainder=drop, pad_final=pad)
    got = list(batch_iterator((a, b), 5, **kw))
    want = list(j_batch_iterator((a, b), 5, **kw))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for x, y in zip(g, w):
            np.testing.assert_array_equal(x, y)


def test_prefetch_to_device_stages_every_batch():
    a = np.arange(10, dtype=np.uint16).reshape(5, 2)
    got = list(prefetch_to_device(batch_iterator((a, np.arange(5)), 2), "cpu"))
    assert [t[0].dtype for t in got] == [torch.uint16] * 3 and got[-1][2].tolist() == [True, False]
    np.testing.assert_array_equal(torch.cat([t[0] for t in got])[:5].numpy(), a)


def test_prefetch_to_device_reraises_producer_errors():
    def batches():
        yield (np.zeros(2),)
        raise KeyError("bad batch")

    it = prefetch_to_device(batches(), "cpu")
    assert torch.equal(next(it)[0], torch.zeros(2, dtype=torch.float64))
    with pytest.raises(KeyError, match="bad batch"):
        next(it)


def _image(seed=0):
    return np.random.default_rng(seed).uniform(size=(40, 56, 1)).astype(np.float32)


def test_rotate_nearest_matches_jax():
    img = _image()
    for angle in (17.0, -123.5, 90.0):
        want = np.asarray(jimg.rotate(jnp.asarray(img), jnp.float32(angle), mode="nearest"))
        got = timg.rotate(torch.from_numpy(img), angle, mode="nearest").numpy()
        assert (got == want).mean() >= 0.995, angle


def test_perspective_warp_bilinear_matches_jax():
    img = _image(1)
    sp = np.array([[0, 0], [55, 0], [55, 39], [0, 39]], np.float32)
    ep = np.array([[3, 2], [50, 5], [53, 36], [1, 33]], np.float32)
    want = np.asarray(jimg.perspective_warp(jnp.asarray(img), jnp.asarray(sp), jnp.asarray(ep)))
    got = timg.perspective_warp(torch.from_numpy(img), torch.from_numpy(sp), torch.from_numpy(ep)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_random_warp_params_stay_in_their_ranges():
    gen = torch.Generator().manual_seed(0)
    angles = torch.stack([timg.random_rotation_params(gen, 30.0) for _ in range(200)])
    assert angles.abs().max() <= 30.0 and angles.min() < -20 and angles.max() > 20
    for _ in range(50):
        sp, ep = timg.random_perspective_params(gen, 40, 56, 0.3)
        off = (ep - sp).abs()
        assert off[:, 0].max() <= int(0.3 * 28) and off[:, 1].max() <= int(0.3 * 20)
        assert torch.equal(ep, ep.round())


def test_build_ir_dataset_matches_jax():
    _, _, _, xs, ys, _, _ = synthetic_openeds2019(4, 4, seed=0, height=H, width=W)
    want_x, want_y = j_build_ir_dataset(xs, ys, JRITnet.pretrained(), jax.random.PRNGKey(0), out_size=(32, 32),
                                        chunk=8)
    got_x, got_y = build_ir_dataset(xs, ys, RITnet.pretrained(), torch.Generator().manual_seed(0),
                                    out_size=(32, 32), chunk=3)
    np.testing.assert_array_equal(got_y, want_y)
    assert got_x.dtype == np.uint16 and got_x.shape == want_x.shape == (len(xs), 32, 32, 1)
    close = np.abs(got_x.astype(np.int64) - want_x.astype(np.int64)) <= 1
    assert close.mean() >= 0.97, close.mean()


def test_build_ir_dataset_augments_with_its_generator():
    _, _, _, xs, ys, _, _ = synthetic_openeds2019(2, 2, seed=0, height=H, width=W)
    args = (xs, ys, RITnet.pretrained())
    kw = dict(rotation_prob=1.0, rotation_degree=45.0, perspect_prob=1.0, out_size=(32, 32))
    a, _ = build_ir_dataset(*args, torch.Generator().manual_seed(3), **kw)
    b, _ = build_ir_dataset(*args, torch.Generator().manual_seed(3), **kw)
    plain, _ = build_ir_dataset(*args, torch.Generator().manual_seed(3), out_size=(32, 32))
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, plain)


def test_dropout():
    x = torch.rand(100_000) + 0.5
    assert tl.dropout(x, 0.5, torch.Generator().manual_seed(0), train=False) is x
    assert tl.dropout(x, 0.5, None, train=True) is x
    y = tl.dropout(x, 0.5, torch.Generator().manual_seed(0), train=True)
    kept = y != 0
    assert torch.equal(y[kept], 2 * x[kept])
    n = x.numel()
    assert abs(kept.sum().item() - 0.5 * n) <= 3 * (0.25 * n) ** 0.5
    assert torch.equal(y, tl.dropout(x, 0.5, torch.Generator().manual_seed(0), train=True))
    assert not torch.equal(y, tl.dropout(x, 0.5, torch.Generator().manual_seed(1), train=True))


# ---------------------------------------------------------------------------
# the training step: two Adam steps against optax, VGG19 frozen and trained
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def heads():
    """JAX-layout params, built once: Classifier1's fc0 is 25088 x 4096."""
    k = jax.random.split(jax.random.PRNGKey(0), 3)
    return {"vgg": _np_tree(jax.jit(JVGG.init)(k[0])),
            "c1": _np_tree(jax.jit(lambda kk: JC1.init(kk, NUM_CLASS))(k[1])),
            "c2": _np_tree(jax.jit(lambda kk: JC2.init(kk, num_class=NUM_CLASS))(k[2]))}


def _jax_two_steps(heads, x, y, train_vgg):
    """(grads of the first step, params after two steps) of optax.adam(1e-3)."""
    tp = {"c1": heads["c1"], "c2": heads["c2"]}
    if train_vgg:
        tp["vgg"] = heads["vgg"]

    def loss_fn(tp, xb, yb):
        xb = jimg.gray_to_rgb(jimg.to_unit_float(xb))
        final, _, style = JVGG.apply(tp.get("vgg", heads["vgg"]), xb, compute_dtype=jnp.float32)
        return j_cross_entropy(JC1.apply(tp["c1"], final), yb) + j_cross_entropy(JC2.apply(tp["c2"], style), yb)

    opt = optax.adam(1e-3)

    @jax.jit
    def step(tp, st, xb, yb):
        g = jax.grad(loss_fn)(tp, xb, yb)
        upd, st = opt.update(g, st, tp)
        return optax.apply_updates(tp, upd), st, g

    st = opt.init(tp)
    tp, st, g1 = step(tp, st, jnp.asarray(x[0]), jnp.asarray(y[0]))
    g1 = _np_tree(g1)
    tp, _, _ = step(tp, st, jnp.asarray(x[1]), jnp.asarray(y[1]))
    return g1, _np_tree(tp)


def _rel(got, want):
    """Per leaf: (max|got - want| / max|want|, ||got - want|| / ||want||)."""
    out = []
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want), strict=True):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        d = np.abs(g - w)
        out.append((d.max() / np.abs(w).max(), np.linalg.norm(d) / np.linalg.norm(w)))
    return np.array(out)


@pytest.mark.parametrize("train_vgg", [False, True])
def test_two_adam_steps_match_optax(heads, train_vgg):
    rng = np.random.default_rng(5)
    x = rng.integers(0, 65536, (2, 2, 32, 32, 1)).astype(np.uint16)
    y = rng.integers(0, NUM_CLASS, (2, 2)).astype(np.int32)
    want_g1, want = _jax_two_steps(heads, x, y, train_vgg)

    train_params = {"c1": from_jax(heads["c1"]), "c2": from_jax(heads["c2"])}
    vgg_frozen = None
    if train_vgg:
        train_params["vgg"] = from_jax(heads["vgg"])
    else:
        vgg_frozen = VGG19.cast(from_jax(heads["vgg"]), torch.float32)
    opt = torch.optim.Adam(wl.trainable(train_params), lr=1e-3)
    train_step, _ = wl.make_steps(torch.float32)
    train_step(train_params, opt, vgg_frozen, torch.from_numpy(x[0]), torch.from_numpy(y[0]), None)
    grads = jax.tree.map(lambda t: t.grad, train_params)
    g_err = _rel(to_jax(grads), want_g1)
    del grads
    train_step(train_params, opt, vgg_frozen, torch.from_numpy(x[1]), torch.from_numpy(y[1]), None)
    p_err = _rel(to_jax(train_params), want)
    assert g_err[:, 0].max() <= 1e-4, g_err
    assert p_err[:, 1].max() <= 1e-4, p_err


def _adam_f64(p0, gs, lr, b1=0.9, b2=0.999, eps=1e-8):
    m = v = 0.0
    p = p0.astype(np.float64)
    for t, g in enumerate(gs, 1):
        g = g.astype(np.float64)
        m, v = b1 * m + (1 - b1) * g, b2 * v + (1 - b2) * g * g
        p = p - lr * (m / (1 - b1**t)) / (np.sqrt(v / (1 - b2**t)) + eps)
    return p


def test_adam_matches_optax_on_the_same_gradients():
    """torch.optim.Adam(lr) against optax.adam(lr) and an f64 Adam over two
    steps whose gradients span 1e-10..1 (around eps) and change sign.  The
    updates (p - p0) are compared, relative to their largest element: torch
    within 1e-6 of the f64 Adam, optax within 1e-5 of torch (optax forms
    1 - b2**t in float32, 1.3e-5 off at t = 1, so its updates sit about
    8e-6 from the f64 ones).  Adam's step does not read the parameters, so
    they start at 0 and hold the updates without a float32 rounding of
    p0 + u."""
    rng = np.random.default_rng(3)
    p0 = {"w": np.zeros((64, 32), np.float32), "b": np.zeros(32, np.float32)}
    scale = 10.0 ** rng.uniform(-10, 0, (2, 64 * 32 + 32))
    gs = [{"w": (rng.standard_normal((64, 32)) * scale[i, :2048].reshape(64, 32)).astype(np.float32),
           "b": (rng.standard_normal(32) * scale[i, 2048:]).astype(np.float32)} for i in range(2)]
    opt = optax.adam(1e-3)
    pj, st = p0, opt.init(p0)
    for g in gs:
        upd, st = opt.update(g, st, pj)
        pj = optax.apply_updates(pj, upd)
    pt = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    topt = torch.optim.Adam(list(pt.values()), lr=1e-3)
    for g in gs:
        for k, t in pt.items():
            t.grad = torch.from_numpy(g[k])
        topt.step()
    for k in p0:
        u_t = pt[k].numpy().astype(np.float64) - p0[k]
        u_64 = _adam_f64(p0[k], [g[k] for g in gs], 1e-3) - p0[k]
        u_j = np.asarray(pj[k], np.float64) - p0[k]
        np.testing.assert_allclose(u_t, u_64, rtol=0, atol=1e-6 * np.abs(u_64).max())
        np.testing.assert_allclose(u_t, u_j, rtol=0, atol=1e-5 * np.abs(u_j).max())


# ---------------------------------------------------------------------------
# checkpoints in the JAX format
# ---------------------------------------------------------------------------


def test_to_jax_inverts_from_jax(heads):
    for tree in (heads["vgg"], {"c1": heads["c1"], "c2": heads["c2"]}):
        back = to_jax(from_jax(tree))
        assert jax.tree.structure(back) == jax.tree.structure(tree)
        for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
            np.testing.assert_array_equal(a, b)


def test_port_checkpoints_load_in_jax_and_in_the_ist_main(tmp_path):
    rng = np.random.default_rng(0)
    heads = {name: {f"fc{i}": {"w": rng.standard_normal((3 + i, 4 + i)).astype(np.float32),
                               "b": rng.standard_normal(4 + i).astype(np.float32)} for i in range(3)}
             for name in ("c1", "c2")}
    params = from_jax(heads)
    path = tckpt.save_checkpoint(str(tmp_path), 4, {"params": params, "step": 4})
    assert os.path.basename(path) == "step_00000004.npz"
    step, tree = j_restore_checkpoint(str(tmp_path))
    assert step == 4 and tree["step"].shape == () and int(tree["step"]) == 4
    for a, b in zip(jax.tree.leaves(tree["params"]), jax.tree.leaves(heads)):
        np.testing.assert_array_equal(a, b)
    step_t, tree_t = tckpt.restore_checkpoint(str(tmp_path))
    assert step_t == 4 and jax.tree.structure(tree_t) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(tree_t), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)
    back = tckpt.restore_params(str(tmp_path))
    for a, b in zip(jax.tree.leaves(to_jax(back)), jax.tree.leaves(heads)):
        np.testing.assert_array_equal(a, b)
    # the 2019 IST main's -path1 / -path2 pick their head from a trainer checkpoint
    c1 = ist._load_head(path, "c1", None, "cpu")
    c2 = ist._load_head(str(tmp_path), "c2", None, "cpu")
    assert torch.equal(c1["fc1"]["w"], params["c1"]["fc1"]["w"])
    assert torch.equal(c2["fc2"]["b"], params["c2"]["fc2"]["b"])
    assert ist._load_head("", "c1", "default", "cpu") == "default"


def test_save_state_round_trips(tmp_path):
    state = ({"a": torch.arange(6.0).reshape(2, 3), "l": [torch.ones(2, dtype=torch.int32)]}, 7)
    tckpt.save_state(str(tmp_path), 3, state)
    tckpt.save_state(str(tmp_path), 5, state)
    assert tckpt.latest_state_step(str(tmp_path)) == 5
    template = ({"a": torch.zeros(2, 3), "l": [torch.zeros(2, dtype=torch.int32)]}, 0)
    step, (tree, epoch) = tckpt.restore_state(str(tmp_path), template)
    assert step == 5 and epoch == 7
    assert torch.equal(tree["a"], state[0]["a"]) and torch.equal(tree["l"][0], state[0]["l"][0])
    assert tckpt.restore_state(str(tmp_path / "none"), template) is None
