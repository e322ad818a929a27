"""Synthetic eye-image generator for tests, demos and benchmarks.

A copy of ``iris_style_transfer_tpu/data/synthetic.py`` (numpy only): the
original cannot be imported without JAX, because its package's
``__init__`` imports the JAX loaders.  A test holds the two to the same
arrays.

The real OpenEDS datasets require a license and are not bundled (reference
``readme.md`` dataset notes); this generator produces eye-like frames
(sclera/iris/pupil ellipses with per-user iris texture + glints) and
matching 4-class segmentation maps with the same shapes, value ranges and
label conventions, so every workload and test runs end-to-end without the
datasets.
"""

from __future__ import annotations

import numpy as np


def synthetic_eye_batch(
    n: int,
    height: int = 400,
    width: int = 640,
    num_users: int = 8,
    seed: int = 0,
    gaze: bool = False,
):
    """Returns (images (N, H, W, 1) float32 [0,1], seg labels (N, H, W)
    int32 in {0 bg, 1 sclera, 2 iris, 3 pupil}, user labels (N,) int32).

    ``gaze=True`` additionally returns unit gaze vectors (N, 3) and moves
    the iris/pupil inside the sclera according to them (an eyeball model:
    the normalized iris-center offset from the eye center IS the gaze's
    x/y component, the OpenEDS2020 signal the 19-d landmark features —
    normalized pupil position, eye corners — are built to recover;
    reference ``gaze_estimators.py:154-174``).  With ``gaze=False`` the
    RNG stream and outputs are bit-identical to the historical generator
    (seeded datasets and tests stay stable)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float32)
    imgs = np.empty((n, height, width, 1), np.float32)
    segs = np.empty((n, height, width), np.int32)
    users = rng.integers(0, num_users, n).astype(np.int32)

    # per-user iris texture frequencies (identity signal)
    tex_freq = rng.uniform(0.05, 0.3, size=(num_users, 2)).astype(np.float32)
    tex_phase = rng.uniform(0, 6.28, size=(num_users, 2)).astype(np.float32)

    if gaze:
        # gaze direction: normalized offsets in [-1, 1]^2, z forward
        offs = rng.uniform(-1.0, 1.0, size=(n, 2)).astype(np.float32)
        gazes = np.concatenate(
            [offs * 0.45, -np.ones((n, 1), np.float32)], axis=1
        )
        gazes /= np.linalg.norm(gazes, axis=1, keepdims=True)

    for i in range(n):
        u = users[i]
        cx = width / 2 + rng.uniform(-40, 40)
        cy = height / 2 + rng.uniform(-30, 30)
        sclera_a, sclera_b = rng.uniform(200, 260), rng.uniform(90, 130)
        iris_r = rng.uniform(55, 80)
        pupil_r = iris_r * rng.uniform(0.3, 0.5)
        if gaze:
            # iris center displaced from the eye center by the gaze's x/y
            # offset, scaled so the iris stays inside the sclera ellipse
            icx = cx + offs[i, 0] * 0.45 * (sclera_a - iris_r)
            icy = cy + offs[i, 1] * 0.45 * (sclera_b - iris_r)
        else:
            icx, icy = cx, cy

        d_scl = ((xx - cx) / sclera_a) ** 2 + ((yy - cy) / sclera_b) ** 2
        d_iris = (xx - icx) ** 2 + (yy - icy) ** 2
        seg = np.zeros((height, width), np.int32)
        seg[d_scl <= 1.0] = 1
        seg[d_iris <= iris_r**2] = 2
        seg[d_iris <= pupil_r**2] = 3

        img = np.full((height, width), 0.35, np.float32)
        img[seg == 1] = 0.85
        theta = np.arctan2(yy - icy, xx - icx)
        rr = np.sqrt(d_iris)
        texture = 0.35 + 0.18 * np.sin(tex_freq[u, 0] * rr + tex_phase[u, 0]) * np.cos(
            8 * theta * tex_freq[u, 1] * 10 + tex_phase[u, 1]
        )
        img = np.where(seg == 2, texture.astype(np.float32), img)
        img[seg == 3] = 0.05
        # glint: a small bright spot on the iris
        gx = icx + rng.uniform(-iris_r / 2, iris_r / 2)
        gy = icy + rng.uniform(-iris_r / 2, iris_r / 2)
        glint = np.exp(-(((xx - gx) ** 2 + (yy - gy) ** 2) / 18.0))
        img = np.clip(img + glint.astype(np.float32), 0.0, 1.0)
        img += rng.normal(0, 0.01, img.shape).astype(np.float32)
        imgs[i, ..., 0] = np.clip(img, 0.0, 1.0)
        segs[i] = seg

    if gaze:
        return imgs, segs, users, gazes
    return imgs, segs, users


def synthetic_openeds2019(
    n_per_user: int = 6, num_users: int = 8, seed: int = 0, height: int = 400, width: int = 640
):
    """Shaped like ``load_data_openeds2019`` output: (train_x, train_y,
    train_m, test_x, test_y, test_m, class_count) with an 80/20 split —
    including its uint8 image contract (same RNG stream as ever; the
    float eyes are quantized at source so downstream builders and H2D
    stay compact, as with real decoded data)."""
    n = n_per_user * num_users
    imgs, segs, users = synthetic_eye_batch(n, height, width, num_users, seed)
    imgs = np.round(np.clip(imgs, 0.0, 1.0) * 255.0).astype(np.uint8)
    order = np.argsort(users, kind="stable")
    train_x, train_y, train_m, test_x, test_y, test_m = [], [], [], [], [], []
    for u in range(num_users):
        idx = order[users[order] == u]
        n_test = max(1, int(round(len(idx) * 0.2)))
        for j, i in enumerate(idx):
            dst = (test_x, test_y, test_m) if j < n_test else (train_x, train_y, train_m)
            dst[0].append(imgs[i])
            dst[1].append(int(users[i]))
            dst[2].append(segs[i])
    return train_x, train_y, train_m, test_x, test_y, test_m, num_users
