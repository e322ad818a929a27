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


def _kernel_unions(mask: np.ndarray, connectivity: int, th: int = tc.TILE_H,
                   tw: int = tc.TILE_W) -> list[tuple[int, int]]:
    """The unions ``ops/csrc/connected.cu`` makes on th x tw tiles.
    ``ccl_tile_kernel``, inside each tile: every pixel with its row run's
    first pixel (its node); then, for each pair of adjacent rows of the
    tile, the run below with the runs above: under 4-connectivity with the
    run above each pixel whose N is set and starts there (or is the run's
    first pixel); under 8, at the run's first pixel with the run above that
    covers its NW (else its N), and at each pixel whose NE starts a run
    above (N not set).  Then ``ccl_seam_kernel``, on the pixels of a tile's
    first row or first column, with their neighbours in the other tiles: W
    and N under 4-connectivity; under 8, on a first row N alone where N is
    set, else NW and NE; on a first column W alone where W is set, else NW
    (off a first row) and SW."""
    h, w = mask.shape

    def m(y, x):
        return bool(mask[y, x])

    def start(y, x, x0):  # the first pixel of the run of row y that holds x, in the tile from x0
        while x > x0 and mask[y, x - 1]:
            x -= 1
        return y * w + x

    pairs = []
    for y in range(h):
        for x in range(w):
            if not mask[y, x]:
                continue
            i = y * w + x
            ly, lx = y % th, x % tw
            x0 = x - lx
            tile_w = min(tw, w - x0)
            node = start(y, x, x0)
            pairs.append((i, node))
            if ly == 0:
                continue
            n = m(y - 1, x)
            nw = lx > 0 and m(y - 1, x - 1)
            ne = lx + 1 < tile_w and m(y - 1, x + 1)
            first = node == i
            if connectivity == 1:
                if n and (first or not nw):
                    pairs.append((node, start(y - 1, x, x0)))
                continue
            if first and (nw or n):
                pairs.append((node, start(y - 1, x - 1 if nw else x, x0)))
            if ne and not n:
                pairs.append((node, i - w + 1))
    for y in range(h):
        for x in range(w):
            first_row, first_col = y % th == 0 and y > 0, x % tw == 0 and x > 0
            if not (first_row or first_col) or not mask[y, x]:
                continue
            i = y * w + x
            if connectivity == 1:
                pairs += [(i, i - 1)] * (first_col and m(y, x - 1)) + [(i, i - w)] * (first_row and m(y - 1, x))
                continue
            if first_row:
                if m(y - 1, x):
                    pairs.append((i, i - w))
                else:
                    pairs += [(i, i - w - 1)] * (x > 0 and m(y - 1, x - 1))
                    pairs += [(i, i - w + 1)] * (x + 1 < w and m(y - 1, x + 1))
            if first_col:
                if m(y, x - 1):
                    pairs.append((i, i - 1))
                else:
                    pairs += [(i, i - w - 1)] * (not first_row and m(y - 1, x - 1))
                    pairs += [(i, i + w - 1)] * (y + 1 < h and m(y + 1, x - 1))
    return pairs


def _union_find_labels(mask: np.ndarray, pairs) -> np.ndarray:
    """Min-root union-find over ``pairs``: 0 for background, else 1 + the
    least index of the pixel's set, as the kernel's labels."""
    parent = np.arange(mask.size)

    def find(i):
        while parent[i] != i:
            i = parent[i]
        return i

    for a, b in pairs:
        ra, rb = sorted((find(a), find(b)))
        parent[rb] = ra
    return np.array([find(i) + 1 for i in range(mask.size)]).reshape(mask.shape) * mask


@pytest.mark.parametrize("connectivity", [1, 2])
def test_kernel_union_rules_connect_every_component(connectivity):
    """The kernel unites row runs inside its tiles and then pixels across
    the tiles' seams, skipping the unions that others imply (one union per
    pair of touching runs; on the seams, Wu, Otoo & Suzuki's rule); min-root
    union-find over exactly those unions at the kernel's tile must still
    give scipy's partition with least-index roots.  The kernel itself runs only on the card (``chip_smoke.py`` and
    ``tests/test_torch_cuda.py``)."""
    for kind in ("blobs", "noise0.45", "noise0.6"):
        for mask in _masks(kind):
            labels = _union_find_labels(mask, _kernel_unions(mask, connectivity))
            want = tc.connected_components(torch.from_numpy(mask[None]), connectivity)[0].numpy()
            np.testing.assert_array_equal(labels, want)


def _seam_masks(h: int, w: int, th: int, tw: int) -> dict:
    """Masks whose components cross th x tw tile seams: one-pixel stripes on
    both sides of every seam, broken at random; a checkerboard (every pixel
    alone under 4-connectivity, one component under 8); pairs of pixels
    touching only diagonally across every tile corner; and a serpentine."""
    rng = np.random.default_rng(7)
    stripes = np.zeros((h, w), bool)
    for y in range(th, h, th):
        stripes[y - 1, 1::3] = stripes[y, ::2] = True
    for x in range(tw, w, tw):
        stripes[::2, x - 1] = stripes[1::3, x] = True
    stripes &= rng.random((h, w)) < 0.9
    corners = np.zeros((h, w), bool)
    for k, y in enumerate(range(th, h, th)):
        for j, x in enumerate(range(tw, w, tw)):
            if (k + j) % 2:
                corners[y - 1, x - 1] = corners[y, x] = True  # NW-SE
            else:
                corners[y - 1, x] = corners[y, x - 1] = True  # NE-SW
    return {"seam stripes": stripes, "checkerboard": (np.add.outer(np.arange(h), np.arange(w)) % 2) == 0,
            "corner diagonals": corners, "serpentine": _serpentine(h, w)}


@pytest.mark.parametrize("connectivity", [1, 2])
@pytest.mark.parametrize("shape,tile", [((48, 64), (7, 9)), ((48, 64), (10, 24)), ((70, 150), (tc.TILE_H, tc.TILE_W))],
                         ids=["7x9", "10x24", "kernel_tile_ragged"])
def test_tile_and_seam_unions_give_the_plain_labels(shape, tile, connectivity):
    """The kernel's union set at tiles that divide neither H nor W (so the
    last tile row and column are ragged) gives the plain version's labels
    exactly, on blobs, noise at 0.45 and 0.6, the serpentine, and stripes,
    a checkerboard and diagonal pairs placed on the tiles' seams and
    corners."""
    h, w = shape
    rng = np.random.default_rng(11)
    masks = {"blobs": _blobs(rng, 1, h, w)[0], "noise0.45": rng.random((h, w)) < 0.45,
             "noise0.6": rng.random((h, w)) < 0.6, **_seam_masks(h, w, *tile)}
    for kind, mask in masks.items():
        labels = _union_find_labels(mask, _kernel_unions(mask, connectivity, *tile))
        want = tc.connected_components_plain(torch.from_numpy(mask[None]), connectivity)[0].numpy()
        np.testing.assert_array_equal(labels, want, err_msg=kind)
    n_corner = ndi.label(masks["corner diagonals"], structure=STRUCTURE[connectivity])[1]
    assert n_corner == masks["corner diagonals"].sum() // connectivity  # pairs under 8, single pixels under 4


@pytest.mark.parametrize("connectivity", [1, 2])
def test_plain_areas_are_the_component_sizes(connectivity):
    """``connected_components_with_areas`` on a CPU tensor: the plain
    labels, and at each label (a component's least index + 1) the
    component's pixel count from ``np.bincount`` of scipy's labels; 0 at
    every other entry, the background's included; no kernel launch."""
    masks = np.concatenate([_masks("blobs"), _masks("noise0.45")])
    before = tc.LAUNCHES["connected_components"]
    lab, areas = tc.connected_components_with_areas(torch.from_numpy(masks), connectivity)
    assert tc.LAUNCHES["connected_components"] == before
    assert areas.dtype == torch.int32 and areas.shape == (len(masks), H * W + 1)
    np.testing.assert_array_equal(lab.numpy(), tc.connected_components_plain(torch.from_numpy(masks),
                                                                            connectivity).numpy())
    for i, mask in enumerate(masks):
        ref, n = ndi.label(mask, structure=STRUCTURE[connectivity])
        sizes = np.bincount(ref.ravel(), minlength=n + 1)
        want = np.zeros(H * W + 1, np.int64)
        for c in range(1, n + 1):
            want[np.flatnonzero(ref == c)[0] + 1] = sizes[c]
        np.testing.assert_array_equal(areas[i].numpy(), want)


@pytest.mark.parametrize("connectivity", [1, 2])
def test_largest_component_matches_jax(connectivity):
    masks = np.concatenate([_masks("blobs"), _masks("noise0.3"), _masks("noise0.45"), np.zeros((1, H, W), bool)])
    got = tc.largest_component(torch.from_numpy(masks), connectivity).numpy()
    np.testing.assert_array_equal(got, _jax(jc.largest_component, masks, connectivity))
    assert got.dtype == bool and got[:-1].any(axis=(1, 2)).all() and not got[-1].any()
