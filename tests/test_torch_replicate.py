"""The port's replication tools (``iris_style_transfer_tpu_torch/tools``)
against the JAX tools (``tools/replicate_*.py``) on the CPU.

The JAX side is the JAX tools themselves, loaded by path.  Their losses and
gradients are read inside their jitted steps through ``jax.debug.callback``
on wrappers of the loss and of ``optax.adam``; nothing of the tools
changes.  Inputs come from the seeded twin at small frames, and the JAX
inits reach the port through ``models.port.from_jax``.

Tolerances, each stated at its test: RITnet's training losses rtol 1e-4
and its mIoU atol 1e-3 (float32 on both sides; the JAX tool's jitted
gamma/CLAHE moves some inputs by one level, ROADMAP section 3); one B7
training step in float32 against the JAX tool's step with its bf16 cast
made float32: loss rtol 1e-5, gradients 1e-3 of each leaf's largest, the
Adam updates element by element, and the port's bf16 step within 2e-2 (loss)
and 0.1 (gradient norm) of its float32 one; the estimators' losses 1e-5 and
gradients within 1e-4 of each leaf's largest; the tools' summaries by their
keys, finite, accuracies in [0, 1].
"""

import ast
import importlib.util
import json
import os
import re
import shutil

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from iris_style_transfer_tpu.models import EfficientNet as JEfficientNet
from iris_style_transfer_tpu.models import layers as jlayers
from iris_style_transfer_tpu.ops import metrics as jmetrics

from iris_style_transfer_tpu_torch.data import synthetic as tsyn
from iris_style_transfer_tpu_torch.models import layers as tlayers
from iris_style_transfer_tpu_torch.models.port import from_jax, to_jax
from iris_style_transfer_tpu_torch.tools import replicate_rotation as rr
from iris_style_transfer_tpu_torch.tools import replicate_synthetic as rs
from iris_style_transfer_tpu_torch.tools import replicate_synthetic_gaze as rg
from iris_style_transfer_tpu_torch.workloads import iris_classification as wl

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W = 48, 64  # divisible through RITnet's pools, CLAHE's 8x8 grid and, padded by 16, B7's /32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's side here is many small ops; one intra-op thread keeps
    them off the other test workers' cores (an OpenMP pool per worker
    oversubscribes the machine)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_tool(name):
    path = os.path.join(REPO, "tools", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"jax_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _u8(imgs):
    return np.round(np.clip(imgs, 0.0, 1.0) * 255.0).astype(np.uint8)


class _Record:
    """Host-side record of values computed inside a JAX tool's jitted step."""

    def __init__(self):
        self.losses, self.grads, self.init = [], [], None

    def loss(self, fn):
        def wrapped(*a, **k):
            out = fn(*a, **k)
            jax.debug.callback(lambda v: self.losses.append(np.asarray(v, np.float64).mean()), out)
            return out

        return wrapped

    def adam(self, make):
        def wrapped(*a, **k):
            tx = make(*a, **k)

            def update(g, state, params=None):
                jax.debug.callback(lambda gg: self.grads.append(_np_tree(gg)), g)
                return tx.update(g, state, params)

            def init(params):  # the tool's init, outside its jitted step
                self.init = _np_tree(params)
                return tx.init(params)

            return optax.GradientTransformation(init, update)

        return wrapped


def _record(monkeypatch, loss_name):
    """A record of a JAX tool's init, gradients and, with ``loss_name``,
    the losses of ``optax.<loss_name>``."""
    rec = _Record()
    monkeypatch.setattr(optax, "adam", rec.adam(optax.adam))
    if loss_name:
        monkeypatch.setattr(optax, loss_name, rec.loss(getattr(optax, loss_name)))
    return rec


def _rel(got, want):
    """Per leaf: max|got - want| / max|want|."""
    return np.array([np.abs(np.asarray(g, np.float64) - np.asarray(w, np.float64)).max()
                     / max(np.abs(np.asarray(w)).max(), 1e-30)
                     for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want), strict=True)])


# ---------------------------------------------------------------------------
# stage 0 of the recognition tool: RITnet on the twin
# ---------------------------------------------------------------------------


def test_train_ritnet_matches_the_jax_tool(monkeypatch):
    """Two epochs of two steps from the JAX tool's init (``RITnet.init(PRNGKey(7))``)
    on uint8 frames, as the JAX tool's main passes them.  Each step's loss
    within rtol 1e-4 and the train mIoU within 1e-3: float32 on both sides,
    and the JAX tool's jitted transform moves some inputs by one level.
    Float frames and their uint8 quantization train to the same bits (the
    dequantize contract)."""
    imgs, segs, _ = tsyn.synthetic_eye_batch(8, H, W, seed=3)
    imgs_u8 = _u8(imgs)
    rec = _record(monkeypatch, "softmax_cross_entropy_with_integer_labels")
    _, miou_j = _jax_tool("replicate_synthetic").train_ritnet(list(imgs_u8), list(segs), epochs=2, bs=4)
    init = rec.init

    params, miou, losses = rs.train_ritnet(list(imgs_u8), list(segs), epochs=2, bs=4, init_params=from_jax(init))
    assert len(rec.losses) == len(losses) == 4
    np.testing.assert_allclose(losses.numpy(), rec.losses, rtol=1e-4)
    assert abs(miou - miou_j) <= 1e-3 and 0.0 <= miou <= 1.0

    dequantized = list(imgs_u8.astype(np.float32) / 255.0)
    params_f, miou_f, losses_f = rs.train_ritnet(dequantized, list(segs), epochs=2, bs=4, init_params=from_jax(init))
    assert miou_f == miou and torch.equal(losses_f, losses)
    for a, b in zip(jax.tree.leaves(params_f), jax.tree.leaves(params)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# stage 0 of the gaze tool: one B7 training step
# ---------------------------------------------------------------------------


def _filled_b7():
    """B7 parameters in the JAX layout, drawn at fan-in scale with batchnorm
    off the identity (the seeded init's batchnorm is the identity and its
    conv biases zero); JAX's eager 64M-parameter init takes half a minute."""
    rng = np.random.default_rng(0)

    def leaf(path, s):
        name = getattr(path[-1], "key", "")
        if name == "w":
            return (rng.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        return (rng.standard_normal(s.shape) * 0.1).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, jax.eval_shape(JEfficientNet.init, jax.random.PRNGKey(0)))


class _Float32For16:
    """``jax.numpy`` with ``bfloat16`` standing for ``float32``: the JAX
    tool's step computed in float32."""

    bfloat16 = jnp.float32

    def __getattr__(self, name):
        return getattr(jnp, name)


def _b7_updates(params, init):
    return np.concatenate([(np.asarray(p, np.float64) - q).ravel()
                           for p, q in zip(jax.tree.leaves(params), jax.tree.leaves(init))])


def _b7_grads(params):
    """The port's gradients in the JAX layout; zeros for parameters the
    forward does not read (the stem's and depthwise convs' biases)."""
    return jax.tree.leaves(to_jax(jax.tree.map(lambda t: torch.zeros_like(t) if t.grad is None else t.grad, params)))


def test_b7_training_step_matches_the_jax_tool(monkeypatch):
    """One step of ``train_efficientnet`` (pad 8 + 8, eval batchnorm, crop,
    cross entropy, Adam 1e-3) on two 16 x 32 frames, from one parameter
    tree that stands in for ``EfficientNet.init`` on both sides.

    The JAX tool's step runs with its bf16 cast made float32, against the
    port's step in float32: the loss within rtol 1e-5, each gradient leaf
    within 1e-3 of its largest magnitude (55 MBConv blocks of float32 sums
    in another order, the depthwise backward the port's own; measured
    2.7e-6).  Adam's first step moves an element by ``lr * g / (|g| +
    eps)``, about ``lr`` times the sign of its gradient, so a gradient
    within rounding of zero can move its element by up to ``2 lr`` the other
    way, and one near eps = 1e-8 by a share of that: the updates are held to
    ``1e-3 lr`` on >= 99.9% of the elements (measured: all but 1e-6) and to
    ``2 lr`` everywhere (measured: 0.04 lr).  Then the port's default bf16
    step from the same tree: its loss within 2e-2 of the float32 one and
    its gradient, over all leaves together, within 0.1 of the float32 one in
    norm (bf16 activations through 55 blocks; measured 0.017)."""
    imgs, segs, _ = tsyn.synthetic_eye_batch(2, 16, 32, seed=5)
    rec = _record(monkeypatch, "softmax_cross_entropy_with_integer_labels")
    init = _filled_b7()
    monkeypatch.setattr(JEfficientNet, "init", staticmethod(lambda key, dtype=jnp.float32: init))
    tool = _jax_tool("replicate_synthetic_gaze")
    monkeypatch.setattr(tool, "jnp", _Float32For16())
    want = _np_tree(tool.train_efficientnet(imgs, segs, epochs=1, bs=2))

    lr = 1e-3
    params, losses = rg.train_efficientnet(imgs, segs, epochs=1, bs=2, init_params=from_jax(init),
                                           dtype=torch.float32)
    assert len(rec.losses) == len(losses) == 1
    np.testing.assert_allclose(losses.numpy(), rec.losses, rtol=1e-5)
    g32 = _b7_grads(params)
    err = _rel(g32, rec.grads[0])
    diff = np.abs(_b7_updates(to_jax(params), init) - _b7_updates(want, init))
    assert err.max() <= 1e-3, err
    assert np.mean(diff <= 1e-3 * lr) >= 0.999 and diff.max() <= 2.0 * lr * (1 + 1e-3)

    params16, losses16 = rg.train_efficientnet(imgs, segs, epochs=1, bs=2, init_params=from_jax(init))
    g16 = np.concatenate([g.ravel() for g in _b7_grads(params16)]).astype(np.float64)
    g32 = np.concatenate([np.asarray(g).ravel() for g in g32]).astype(np.float64)
    assert abs(float(losses16[0]) - float(losses[0])) <= 2e-2 * float(losses[0])
    assert np.linalg.norm(g16 - g32) <= 0.1 * np.linalg.norm(g32)


# ---------------------------------------------------------------------------
# stage 1 of the gaze tool: one step of each estimator, dropout off
# ---------------------------------------------------------------------------


def _no_dropout(monkeypatch):
    monkeypatch.setattr(jlayers, "dropout", lambda x, rate, key, train: x)
    monkeypatch.setattr(tlayers, "dropout", lambda x, rate, gen, train: x)


@pytest.mark.parametrize("estimator", [1, 2])
def test_estimator_step_matches_the_jax_tool(monkeypatch, estimator):
    """One step of ``train_estimator1`` (landmarks of segmentations, full
    batch) or ``train_estimator2`` (ResNet50 on frames, bs 2) from the JAX
    tool's init, dropout off on both sides: the loss within 1e-5 and every
    gradient leaf within 1e-4 of its largest magnitude (ResNet50's 53
    float32 convs summed in another order)."""
    _no_dropout(monkeypatch)
    rec = _record(monkeypatch, None)
    monkeypatch.setattr(jmetrics, "cosine_embedding_loss", rec.loss(jmetrics.cosine_embedding_loss))
    tool = _jax_tool("replicate_synthetic_gaze")
    if estimator == 1:
        _, segs, _, gaze = tsyn.synthetic_eye_batch(6, H, W, seed=7, gaze=True)
        tool.train_estimator1(jnp.asarray(segs), gaze, epochs=1)
        params, losses = rg.train_estimator1(torch.from_numpy(segs), gaze, epochs=1, init_params=from_jax(rec.init))
    else:
        imgs, _, _, gaze = tsyn.synthetic_eye_batch(2, 32, 32, seed=7, gaze=True)
        tool.train_estimator2(imgs, gaze, epochs=1, bs=2)
        params, losses = rg.train_estimator2(imgs, gaze, epochs=1, bs=2, init_params=from_jax(rec.init))
    assert len(rec.losses) == len(rec.grads) == len(losses) == 1
    assert abs(float(losses[0]) - rec.losses[0]) <= 1e-5
    grads = to_jax(jax.tree.map(lambda t: t.grad, params))
    err = _rel(grads, rec.grads[0])
    assert err.max() <= 1e-4, err


# ---------------------------------------------------------------------------
# the tools' mains at tiny size: summaries, the shared VGG19, the crops
# ---------------------------------------------------------------------------


def _jax_tool_ast(name):
    return ast.parse(open(os.path.join(REPO, "tools", f"{name}.py")).read())


def _jax_summary_keys(name, target="summary"):
    """The keys of the ``<target> = {...}`` literal in a JAX tool's main."""
    for node in ast.walk(_jax_tool_ast(name)):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(getattr(t, "id", "") == target for t in node.targets)):
            return {k.value for k in node.value.keys}
    raise AssertionError(f"no {target} literal in tools/{name}.py")


def _jax_key_patterns(name, target="results"):
    """Each ``<target>[f"..."] = ...`` key of a JAX tool as a regex: the
    f-string's literal parts, any run of characters but "/" for each
    formatted value."""
    patterns = set()
    for node in ast.walk(_jax_tool_ast(name)):
        if (isinstance(node, ast.Subscript) and getattr(node.value, "id", "") == target
                and isinstance(node.slice, ast.JoinedStr)):
            patterns.add("".join(re.escape(v.value) if isinstance(v, ast.Constant) else "[^/]+"
                                 for v in node.slice.values))
    return patterns


def _tiny_twin_2019(n_per_user=6, num_users=8, seed=0):
    return tsyn.synthetic_openeds2019(n_per_user, num_users, seed=seed, height=H, width=W)


class _VGGSpy:
    """Stands in for ``VGG19`` in one module and keeps the parameters that
    each call of its method ``method`` received."""

    def __init__(self, real, method):
        self.real, self.method, self.seen = real, method, []

    def __getattr__(self, name):
        fn = getattr(self.real, name)
        if name != self.method:
            return fn

        def spy(params, *a, **k):
            self.seen.append(params)
            return fn(params, *a, **k)

        return spy


@pytest.fixture(scope="module")
def recognition(tmp_path_factory):
    """``replicate_synthetic`` then ``replicate_rotation`` on its checkpoint,
    at 48 x 64 frames, 3 users x 5 frames, one epoch of each trainer and 2
    NST closures, with the VGG19 each stage used."""
    mp = pytest.MonkeyPatch()
    tmp = tmp_path_factory.mktemp("recognition")
    mp.chdir(tmp)
    spies = {"train": _VGGSpy(wl.VGG19, "cast"), "rotation": _VGGSpy(rr.VGG19, "apply")}
    stage2 = []
    real_ist = rs.iris_style_transfer_openeds2019
    mp.setattr(wl, "VGG19", spies["train"])
    mp.setattr(rr, "VGG19", spies["rotation"])
    mp.setattr(rs, "iris_style_transfer_openeds2019", lambda cfg, ds, vgg, *a, **k: stage2.append(vgg) or real_ist(
        cfg, ds, vgg, *a, **k))
    for tool in (rs, rr):
        mp.setattr(tool, "synthetic_openeds2019", _tiny_twin_2019)
    try:
        summary = rs.main(["--ritnet_epochs", "1", "--epochs", "1", "--users", "3", "--n_per_user", "5", "--bs", "4",
                           "--ist_bs", "2", "--nst_epochs", "2", "--device", "cpu", "--out", "results"])
        rotation = rr.main(["--users", "3", "--n_per_user", "5", "--angles", "0,45", "--pers", "0,0.3",
                            "--crop_size", "64", "--chunk", "2", "--device", "cpu", "--out", "results_rotation"])
        written = {name: json.load(open(tmp / f"{name}.json")) for name in ("results", "results_rotation")}
        ckpt = tmp / "saved" / "checkpoints" / "iris_classification"
        yield {"summary": summary, "rotation": rotation, "written": written, "ckpt": str(ckpt),
               "train_vgg": spies["train"].seen[0], "stage2_vgg": stage2[0], "rotation_vgg": spies["rotation"].seen}
    finally:
        mp.undo()
        shutil.rmtree(tmp / "saved", ignore_errors=True)  # Classifier1's fc0 alone is 411 MB per file


def _check_summary(summary, written, keys, accuracy):
    assert summary == written and keys <= set(summary), keys - set(summary)
    for k, v in summary.items():
        assert np.isfinite(v), k
        if accuracy(k):
            assert 0.0 <= v <= 1.0, (k, v)


def test_recognition_main_writes_the_jax_summary(recognition):
    _check_summary(recognition["summary"], recognition["written"]["results"],
                   _jax_summary_keys("replicate_synthetic"), lambda k: "accu" in k or "miou" in k or k == "chance")


def test_rotation_main_writes_the_jax_summary(recognition):
    """The JAX tool's keys on the same flags: its ``results`` literal and,
    per level, each of its key templates (rotation and perspective
    accuracies at 0, 45 and 0, 0.3; retentions at the nonzero levels)."""
    rotation = recognition["rotation"]
    patterns = _jax_key_patterns("replicate_rotation")
    assert len(patterns) == 6
    for key in set(rotation) - _jax_summary_keys("replicate_rotation", "results"):
        assert any(re.fullmatch(p, key) for p in patterns), key
    for p in patterns:  # two levels of a kind, or the two nonzero levels
        assert sum(bool(re.fullmatch(p, key)) for key in rotation) == 2, p
    assert len(rotation) == 1 + 4 * 2 + 2 * 2
    _check_summary(rotation, recognition["written"]["results_rotation"], {"chance", "rot/45/retention_c2"},
                   lambda k: "retention" not in k)


def test_every_stage_uses_the_trainers_vgg19(recognition):
    """The VGG19 that the classifier trainer casts for its frozen forwards,
    the one stage 2 runs the IST pipeline on and the one every rotation
    classification applies are equal in every tensor."""
    train = recognition["train_vgg"]
    for other in [recognition["stage2_vgg"], *recognition["rotation_vgg"]]:
        assert jax.tree.structure(other) == jax.tree.structure(train)
        for a, b in zip(jax.tree.leaves(other), jax.tree.leaves(train)):
            assert torch.equal(a, b)
    assert len(recognition["rotation_vgg"]) == 2 * 6  # 2 chunks x (0, +-45, 0, two draws at 0.3)


def test_gaze_main_writes_the_jax_summary(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(rg, "synthetic_eye_batch", lambda n, seed=0, gaze=False:
                        tsyn.synthetic_eye_batch(n, H, W, seed=seed, gaze=gaze))
    summary = rg.main(["--n_train", "4", "--n_eval", "2", "--effnet_epochs", "1", "--estimator1_steps", "3",
                       "--estimator2_epochs", "1", "--ist_bs", "2", "--nst_epochs", "2", "--device", "cpu",
                       "--out", "results_gaze"])
    _check_summary(summary, json.load(open(tmp_path / "results_gaze.json")),
                   _jax_summary_keys("replicate_synthetic_gaze"), lambda k: k == "effnet/eval_miou")
    assert 0.0 <= summary["pre/degree_distance1"] <= 180.0


def test_masked_test_crops_match_the_jax_tool():
    """The port dequantizes the twin's uint8 frames before the [0,1] glint
    threshold; on the same frames as floats the JAX tool's crops are the
    port's within 1e-5.  Fed the uint8 frames themselves, the JAX tool's
    threshold keeps only zero-valued iris pixels (ROADMAP section 3)."""
    _, _, _, test_x, _, test_m, _ = _tiny_twin_2019(5, 3, seed=4)
    floats = [x.astype(np.float32) / 255.0 for x in test_x]
    jax_rotation = _jax_tool("replicate_rotation")
    want = jax_rotation.masked_test_crops(floats, test_m, out_size=(32, 32), chunk=2)
    got = rr.masked_test_crops(test_x, test_m, out_size=(32, 32), chunk=2)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    assert np.count_nonzero(want) > 0.2 * want.size
    raw = jax_rotation.masked_test_crops(test_x, test_m, out_size=(32, 32), chunk=2)
    assert np.count_nonzero(raw) == 0


@pytest.mark.parametrize("tool", [rs, rr, rg])
def test_tools_refuse_cuda_without_cuda(monkeypatch, tool):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA is not available"):
        tool.main([])
