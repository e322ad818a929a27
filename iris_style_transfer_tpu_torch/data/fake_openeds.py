"""Fake OpenEDS2019 and OpenEDS2020 trees, written from the synthetic twin
in the datasets' on-disk layouts, so that the real-data paths of the four
mains run without the licensed datasets.

    python -m iris_style_transfer_tpu_torch.data.fake_openeds --out /tmp/data \\
        --height 48 --width 64

writes ``/tmp/data/openeds2019`` and ``/tmp/data/openeds2020``; pass
``--data_dir /tmp/data`` to a main.  The layouts, as the loaders read them:

    openeds2019/OpenEDS_{train,validation,test}_userID_mapping_to_images.json
        [{"id": ..., "semantic_segmenation_images": [file names]}, ...]
    openeds2019/Semantic_Segmentation_Dataset/{split}/images/<name>.png
    openeds2019/Semantic_Segmentation_Dataset/{split}/labels/<name>.npy
    openeds2020/openEDS2020-GazePrediction/{train,validation,test}/sequences/<seq>/<frame>.png
    openeds2020/openEDS2020-GazePrediction/{split}/labels/<seq>.txt
        rows "frame index,x,y,z" (17 significant digits); the test split's
        files hold 5 rows more than their frames, and its sequence 2577
        holds the 2020 main's style frame, 023.png

Frames are 8-bit gray PNGs whose row filters cycle through
``utils/png.py:FILTER_TYPES`` frame by frame (0-4 and adaptive), as real
encoders mix them.
"""

from __future__ import annotations

import argparse
import json
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..utils.png import FILTER_TYPES, write_png
from .openeds2019 import MAPPING_KEY, SPLITS
from .synthetic import synthetic_eye_batch

GAZE_DIR = os.path.join("openeds2020", "openEDS2020-GazePrediction")
STYLE_SEQUENCE, STYLE_FRAME = "2577", 23
WRITERS = 8  # threads writing PNGs (zlib releases the GIL)


def _write_frames(items: list[tuple[str, np.ndarray]]) -> None:
    """Each (path, uint8 frame) as a PNG, the k-th with filter type
    ``FILTER_TYPES[k % 6]``."""
    def one(k: int) -> None:
        path, img = items[k]
        write_png(path, img, FILTER_TYPES[k % len(FILTER_TYPES)])

    with ThreadPoolExecutor(max_workers=WRITERS) as pool:
        for f in [pool.submit(one, k) for k in range(len(items))]:
            f.result()


def write_openeds2019(root: str, users: tuple[int, int, int] = (4, 2, 2), frames_per_user: int = 6,
                      height: int = 400, width: int = 640, seed: int = 0) -> str:
    """An OpenEDS2019 tree under ``root/openeds2019`` with ``users[i]``
    users in split i (train, validation, test), about ``frames_per_user``
    frames each (the twin draws each frame's user, so some users hold two
    or fewer and are skipped by the loader, as in the dataset), with
    uint8 segmentation labels.  Returns the tree's path."""
    base = os.path.join(root, "openeds2019")
    n_users = sum(users)
    imgs, segs, owner = synthetic_eye_batch(n_users * frames_per_user, height, width, n_users, seed=seed)
    frames = np.round(np.clip(imgs[..., 0], 0.0, 1.0) * 255.0).astype(np.uint8)
    items, first = [], 0
    for split, n in zip(SPLITS, users):
        d = os.path.join(base, "Semantic_Segmentation_Dataset", split)
        os.makedirs(os.path.join(d, "images"), exist_ok=True)
        os.makedirs(os.path.join(d, "labels"), exist_ok=True)
        mapping = []
        for u in range(first, first + n):
            names = [f"{i:012d}.png" for i in np.flatnonzero(owner == u)]
            mapping.append({"id": f"U{u:03d}", MAPPING_KEY: names})
            for name in names:
                i = int(name[:-4])
                items.append((os.path.join(d, "images", name), frames[i]))
                np.save(os.path.join(d, "labels", name[:-4] + ".npy"), segs[i].astype(np.uint8))
        with open(os.path.join(base, f"OpenEDS_{split}_userID_mapping_to_images.json"), "w") as fh:
            json.dump(mapping, fh)
        first += n
    _write_frames(items)
    return base


def write_openeds2020(root: str, sequences: tuple[int, int, int] = (2, 1, 1), frames_per_sequence: int = 24,
                      height: int = 400, width: int = 640, seed: int = 0) -> str:
    """An OpenEDS2020 gaze tree under ``root/openeds2020/
    openEDS2020-GazePrediction`` with ``sequences[i]`` sequences of
    ``frames_per_sequence`` frames in split i (train, validation, test),
    the twin's geometric gaze (seed ``seed + i``) renormalized in float64
    as labels.  The test split's first sequence is 2577, with at least 24
    frames for the 2020 main's style frame.  Returns the tree's path with a
    trailing slash."""
    base = os.path.join(root, GAZE_DIR)
    items = []
    for s, (split, n) in enumerate(zip(SPLITS, sequences)):
        names = [STYLE_SEQUENCE if split == "test" and q == 0 else f"{1000 * (s + 1) + q:04d}" for q in range(n)]
        lengths = [max(frames_per_sequence, STYLE_FRAME + 1) if name == STYLE_SEQUENCE else frames_per_sequence
                   for name in names]
        imgs, _, _, gaze = synthetic_eye_batch(sum(lengths), height, width, seed=seed + s, gaze=True)
        frames = np.round(np.clip(imgs[..., 0], 0.0, 1.0) * 255.0).astype(np.uint8)
        g64 = gaze.astype(np.float64)
        g64 /= np.linalg.norm(g64, axis=1, keepdims=True)
        extra = 5 if split == "test" else 0
        os.makedirs(os.path.join(base, split, "labels"), exist_ok=True)
        for name, first, length in zip(names, np.cumsum([0] + lengths[:-1]), lengths):
            d = os.path.join(base, split, "sequences", name)
            os.makedirs(d, exist_ok=True)
            rows = np.concatenate([g64[first : first + length], g64[first + length - 1 :][:1].repeat(extra, axis=0)])
            with open(os.path.join(base, split, "labels", name + ".txt"), "w") as fh:
                fh.write("\n".join(f"{i}," + ",".join(f"{v:.17g}" for v in r) for i, r in enumerate(rows)) + "\n")
            items += [(os.path.join(d, f"{i:03d}.png"), frames[first + i]) for i in range(length)]
    _write_frames(items)
    return base + "/"


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", required=True, help="the directory to pass as a main's --data_dir")
    p.add_argument("--height", type=int, default=400)
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    print(write_openeds2019(args.out, height=args.height, width=args.width, seed=args.seed))
    print(write_openeds2020(args.out, height=args.height, width=args.width, seed=args.seed))


if __name__ == "__main__":
    main()
