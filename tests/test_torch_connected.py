"""The port's connected-component labelling (``ops/connected.py``) against
the JAX package's, on the CPU, where a CPU tensor takes the plain version.

Tolerance: exact everywhere (int32 labels and bool masks).  The JAX loop
stops after ``max_iters = h + w`` sweeps, converged or not; the port
computes the converged labelling.  So the port is held to JAX at its
default wherever that has converged (where the default equals
``max_iters=H*W``, at which every mask here converges), to
``max_iters=H*W`` everywhere, and its partition to
``scipy.ndimage.label``'s.
"""

import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

import jax
import jax.numpy as jnp

from iris_style_transfer_tpu.ops import connected as jc

from iris_style_transfer_tpu_torch.ops import connected as tc

B, H, W = 3, 48, 64
STRUCTURE = {1: None, 2: np.ones((3, 3), bool)}  # scipy's cross and 3x3


def _blobs(rng, b=B, h=H, w=W):
    """Ellipses of many sizes, some touching, plus single-pixel specks."""
    yy, xx = np.mgrid[0:h, 0:w]
    out = np.zeros((b, h, w), bool)
    for i in range(b):
        for _ in range(6):
            cy, cx = rng.uniform(0, h), rng.uniform(0, w)
            ry, rx = rng.uniform(1, h / 4), rng.uniform(1, w / 4)
            out[i] |= ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1
        out[i] |= rng.random((h, w)) < 0.01
    return out


def _masks(kind: str) -> np.ndarray:
    rng = np.random.default_rng({"blobs": 0, "noise0.3": 1, "noise0.45": 2, "noise0.6": 3}[kind])
    return _blobs(rng) if kind == "blobs" else rng.random((B, H, W)) < float(kind[5:])


def _jax(fn, masks, *args, **kw):
    return np.asarray(jax.vmap(lambda m: fn(m, *args, **kw))(jnp.asarray(masks)))


def _serpentine(h: int, w: int) -> np.ndarray:
    """Full rows 0, 2, 4, ... joined at alternating ends: one component
    whose path runs through every row."""
    m = np.zeros((h, w), bool)
    m[0::2] = True
    for k, y in enumerate(range(1, h, 2)):
        m[y, w - 1 if k % 2 == 0 else 0] = True
    return m


@pytest.mark.parametrize("connectivity", [1, 2])
@pytest.mark.parametrize("kind", ["blobs", "noise0.3", "noise0.45", "noise0.6"])
def test_labels_match_jax(kind, connectivity):
    masks = _masks(kind)
    got = tc.connected_components(torch.from_numpy(masks), connectivity)
    assert got.dtype == torch.int32 and got.shape == (B, H, W)
    got = got.numpy()
    uncapped = _jax(jc.connected_components, masks, connectivity, max_iters=H * W)
    np.testing.assert_array_equal(got, uncapped)
    default = _jax(jc.connected_components, masks, connectivity)
    converged = [i for i in range(B) if np.array_equal(default[i], uncapped[i])]
    # the capped loop converges on most masks; only 4-connected noise at
    # 0.6 (near the 4-neighbour percolation threshold) winds past h + w
    if (kind, connectivity) == ("noise0.6", 1):
        assert 1 <= len(converged) < B
    else:
        assert len(converged) == B
    for i in converged:
        np.testing.assert_array_equal(got[i], default[i])
    for i in range(B):  # the same partition as scipy, each label its component's least index + 1
        ref, n = ndi.label(masks[i], structure=STRUCTURE[connectivity])
        assert len(np.unique(got[i][masks[i]])) == n
        for lab in range(1, n + 1):
            comp = ref == lab
            assert np.all(got[i][comp] == np.flatnonzero(comp)[0] + 1)
        assert not got[i][~masks[i]].any()


def test_serpentine_is_labelled_whole_where_the_capped_jax_loop_is_not():
    """The reference's ``max_iters = h + w`` cap (ROADMAP, "Found in the
    reference"): a 20x20 serpentine of 210 pixels is one component; the
    capped JAX loop leaves it in 84 labels, so its area opening at 150
    deletes it and its largest component is 45 pixels."""
    m = _serpentine(20, 20)
    assert m.sum() == 210 and ndi.label(m, structure=np.ones((3, 3)))[1] == 1
    jlab = np.asarray(jc.connected_components(jnp.asarray(m)))
    assert len(np.unique(jlab[m])) == 84
    assert np.asarray(jc.area_opening(jnp.asarray(m), 150)).sum() == 0
    assert np.asarray(jc.largest_component(jnp.asarray(m))).sum() == 45

    t = torch.from_numpy(m[None])
    lab = tc.connected_components(t)[0].numpy()
    assert np.all(lab[m] == 1) and not lab[~m].any()
    np.testing.assert_array_equal(lab, np.asarray(jc.connected_components(jnp.asarray(m), max_iters=400)))
    assert int(tc.area_opening(t, 150).sum()) == 210
    assert int(tc.largest_component(t).sum()) == 210
    np.testing.assert_array_equal(tc.connected_components(t, 1)[0].numpy(), lab)  # 4-connected too


def test_largest_component_on_ties_and_empty_masks():
    """Two equal squares: the lower label (the first maximum) wins, as in
    JAX's argmax; an empty mask stays empty."""
    m = np.zeros((3, 20, 24), bool)
    m[0, 2:6, 15:19] = True  # 16 pixels, the lower linear index
    m[0, 10:14, 3:7] = True  # 16 pixels
    m[1, 12:16, 1:5] = True  # 16 pixels: lower-left, but a later index ...
    m[1, 1:5, 18:22] = True  # ... than this one, which wins
    got = tc.largest_component(torch.from_numpy(m)).numpy()
    want = _jax(jc.largest_component, m)
    np.testing.assert_array_equal(got, want)
    assert got[0, 2:6, 15:19].all() and got[0].sum() == 16
    assert got[1, 1:5, 18:22].all() and got[1].sum() == 16
    assert not got[2].any()


@pytest.mark.parametrize("threshold", [1, 50, 500])
def test_area_opening_matches_jax(threshold):
    masks = np.concatenate([_masks("blobs"), _masks("noise0.45")])
    for connectivity in (1, 2):
        got = tc.area_opening(torch.from_numpy(masks), threshold, connectivity).numpy()
        want = _jax(jc.area_opening, masks, threshold, connectivity)
        np.testing.assert_array_equal(got, want)
        assert got.dtype == bool
    if threshold == 1:
        np.testing.assert_array_equal(got, masks)  # nothing is smaller than one pixel


def test_cpu_tensors_take_the_plain_version_and_bad_input_raises():
    m = torch.from_numpy(_masks("noise0.45"))
    before = tc.LAUNCHES["connected_components"]
    np.testing.assert_array_equal(tc.connected_components(m).numpy(), tc.connected_components_plain(m).numpy())
    assert tc.LAUNCHES["connected_components"] == before
    np.testing.assert_array_equal(tc.connected_components(m.to(torch.uint8) * 7).numpy(),
                                  tc.connected_components(m).numpy())  # any nonzero is foreground
    with pytest.raises(ValueError, match="connectivity"):
        tc.connected_components(m, 3)
    with pytest.raises(ValueError, match=r"\(B, H, W\)"):
        tc.connected_components(m[0])
    assert tc.connected_components(torch.zeros((2, 0, 5), dtype=torch.bool)).shape == (2, 0, 5)


def _kernel_unions(mask: np.ndarray, connectivity: int) -> list[tuple[int, int]]:
    """The unions ``ccl_merge_kernel`` (``ops/csrc/connected.cu``) makes:
    W and N under 4-connectivity; under 8, N alone where N is set, else W
    (or NW where W is not set) and NE."""
    h, w = mask.shape
    pairs = []
    for y in range(h):
        for x in range(w):
            if not mask[y, x]:
                continue
            i = y * w + x
            n = y > 0 and bool(mask[y - 1, x])
            west = x > 0 and bool(mask[y, x - 1])
            if connectivity == 1:
                pairs += [(i, i - 1)] * west + [(i, i - w)] * n
            elif n:
                pairs.append((i, i - w))
            else:
                if west:
                    pairs.append((i, i - 1))
                elif x > 0 and y > 0 and mask[y - 1, x - 1]:
                    pairs.append((i, i - w - 1))
                if x + 1 < w and y > 0 and mask[y - 1, x + 1]:
                    pairs.append((i, i - w + 1))
    return pairs


@pytest.mark.parametrize("connectivity", [1, 2])
def test_kernel_union_rules_connect_every_component(connectivity):
    """The kernel skips the 8-connected unions that another pixel's unions
    imply (Wu, Otoo & Suzuki's decision tree); min-root union-find over
    exactly those unions must still give scipy's partition with least-index
    roots.  The kernel itself runs only on the card (``chip_smoke.py`` and
    ``tests/test_torch_cuda.py``)."""
    for kind in ("blobs", "noise0.45", "noise0.6"):
        for mask in _masks(kind):
            parent = np.arange(mask.size)

            def find(i):
                while parent[i] != i:
                    i = parent[i]
                return i

            for a, b in _kernel_unions(mask, connectivity):
                ra, rb = sorted((find(a), find(b)))
                parent[rb] = ra
            labels = np.array([find(i) + 1 for i in range(mask.size)]).reshape(mask.shape) * mask
            want = tc.connected_components(torch.from_numpy(mask[None]), connectivity)[0].numpy()
            np.testing.assert_array_equal(labels, want)
