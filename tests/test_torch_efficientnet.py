"""The port's EfficientNet-B7 U-Net against the JAX package, whole.

One parameter tree, shaped by ``jax.eval_shape(EfficientNet.init)`` and
filled from a numpy generator (batchnorm away from the identity), reaches
both through ``models.port.from_jax``.  Frames are (1, 48, 64, 1): padded
to 64 x 64, the smallest size whose height and width divide by 32.
Tolerances: float32 logits rtol 1e-3 of their scale; labels after the
flip-TTA average >= 99% equal in float32 and >= 98% in bfloat16 (argmax
flips where two classes nearly tie, and bf16 rounds at other points in the
two frameworks); the gradient of the logits under a random cotangent, in
the input and in every parameter, rtol 1e-3 of each gradient's scale (the
port's depthwise backward is its own plain-torch Function, the JAX one
XLA's).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from iris_style_transfer_tpu.models import efficientnet as jeff
from iris_style_transfer_tpu.ops.image import imagenet_normalize as j_normalize

from iris_style_transfer_tpu_torch.data.synthetic import synthetic_eye_batch
from iris_style_transfer_tpu_torch.models import efficientnet as teff
from iris_style_transfer_tpu_torch.models.port import from_jax, to_jax


def _fill(shapes, rng):
    def leaf(path, s):
        name = getattr(path[-1], "key", "")
        if name == "w":
            return (rng.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        return (rng.standard_normal(s.shape) * 0.1).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@pytest.fixture(scope="module")
def b7():
    shapes = jax.eval_shape(jeff.EfficientNet.init, jax.random.PRNGKey(0))
    jp = _fill(shapes, np.random.default_rng(0))
    return shapes, jp, from_jax(jp)


@pytest.fixture(scope="module")
def frames():
    imgs, _, _ = synthetic_eye_batch(1, 48, 64, seed=3)
    return imgs


def test_block_tables_match_jax():
    assert teff.BLOCK_ARGS == jeff.BLOCK_ARGS and len(teff.BLOCK_ARGS) == 55
    assert teff.SKIP_AFTER == jeff.SKIP_AFTER
    assert sum(1 for _, _, s, _, _ in teff.BLOCK_ARGS if s == 1) == 51  # kernel launches per forward
    for args in ((416, 640, 3, 2), (13, 20, 5, 2), (26, 40, 5, 1)):
        assert teff._same_pad(*args) == jeff._same_pad(*args)


def test_weight_tree_carries_over(b7):
    """from_jax keeps the B7 tree's structure (lists of blocks, SE convs),
    turns the (k, k, 1, C) depthwise into (C, 1, k, k), and the port's
    seeded init builds the same tree."""
    shapes, jp, tp = b7
    j_leaves = jax.tree_util.tree_leaves_with_path(shapes)
    t_init = teff.EfficientNet.init(torch.Generator().manual_seed(0))
    for tree in (tp, t_init):
        t_leaves = jax.tree_util.tree_leaves_with_path(tree)
        assert [jax.tree_util.keystr(p) for p, _ in t_leaves] == [jax.tree_util.keystr(p) for p, _ in j_leaves]
        for (_, t), (_, j) in zip(t_leaves, j_leaves):
            want = j.shape
            if len(want) == 4:
                want = (want[3], want[2], want[0], want[1])
            assert tuple(t.shape) == want
    blk = jp["blocks"][10]
    np.testing.assert_array_equal(tp["blocks"][10]["dw_conv"]["w"][:, 0].numpy(),
                                  np.transpose(blk["dw_conv"]["w"][:, :, 0], (2, 0, 1)))
    np.testing.assert_array_equal(tp["blocks"][10]["bn1"]["var"].numpy(), blk["bn1"]["var"])


def test_logits_float32_match_jax(b7, frames):
    _, jp, tp = b7
    x = np.pad(np.repeat(frames, 3, axis=-1), ((0, 0), (8, 8), (0, 0), (0, 0)))
    x = np.array(j_normalize(jnp.asarray(x)))  # writable, for torch.from_numpy
    want = np.asarray(jax.jit(jeff.EfficientNet.logits)(jp, jnp.asarray(x)))
    with torch.no_grad():
        got = teff.EfficientNet.logits(tp, torch.from_numpy(x).permute(0, 3, 1, 2)
                                       .contiguous(memory_format=torch.channels_last))
    got = got.permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3 * np.abs(want).max())


def test_logits_gradients_match_jax(b7, frames):
    """The whole U-Net is differentiable in the port as in the JAX package
    (``tools/replicate_synthetic_gaze.py`` trains through it): every
    parameter's gradient and the input's, against jax.grad."""
    _, jp, tp = b7
    x = np.pad(np.repeat(frames, 3, axis=-1), ((0, 0), (8, 8), (0, 0), (0, 0)))
    x = np.array(j_normalize(jnp.asarray(x)))
    ct = np.random.default_rng(5).standard_normal((1, 64, 64, 4)).astype(np.float32)
    gx_j, gp_j = jax.jit(jax.grad(lambda v, q: jnp.sum(jeff.EfficientNet.logits(q, v) * ct), argnums=(0, 1)))(
        jnp.asarray(x), jp)
    leaves, treedef = jax.tree_util.tree_flatten(jax.tree_util.tree_map(lambda t: t.clone().requires_grad_(True), tp))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last).requires_grad_(True)
    out = teff.EfficientNet.logits(jax.tree_util.tree_unflatten(treedef, leaves), xt)
    grads = torch.autograd.grad(out, [xt, *leaves], torch.from_numpy(ct).permute(0, 3, 1, 2), allow_unused=True)

    def close(got, want):
        want = np.asarray(want)
        np.testing.assert_allclose(np.asarray(got), want, rtol=1e-3, atol=1e-3 * np.abs(want).max())

    close(grads[0].permute(0, 2, 3, 1).numpy(), gx_j)
    got = to_jax(jax.tree_util.tree_unflatten(
        treedef, [torch.zeros_like(t) if g is None else g for t, g in zip(leaves, grads[1:])]))
    jax.tree_util.tree_map(close, got, gp_j)


@pytest.mark.parametrize("dtype,min_equal", [("float32", 0.99), ("bfloat16", 0.98)])
def test_apply_tta_labels_match_jax(b7, frames, dtype, min_equal):
    _, jp, tp = b7
    apply = jax.jit(lambda p, x: jeff.EfficientNet.apply(p, x, compute_dtype=getattr(jnp, dtype)))
    want = np.asarray(apply(jp, jnp.asarray(frames)))
    with torch.no_grad():
        got = teff.EfficientNet.apply(tp, torch.from_numpy(frames), compute_dtype=getattr(torch, dtype))
    assert got.dtype == torch.int32 and got.shape == (1, 48, 64)
    assert (got.numpy() == want).mean() >= min_equal
    assert len(np.unique(want)) > 1  # the seeded net does not collapse to one class
