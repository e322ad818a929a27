"""Threaded frame decode for the host input pipeline.

Counterpart of ``iris_style_transfer_tpu/data/native_loader.py``, whose
libpng/libjpeg library (``native/ist_loader.cpp``) the port does not
assume on its machine.  :func:`decode_gray_batch` decodes same-sized PNGs
on a thread pool through ``utils/png.py``: Python's ``zlib`` inflates and
the compiled helper (``data/csrc/png_unfilter.cpp``) undoes the row
filters and folds colour to gray as PIL's ``convert("L")`` does.  Both
release the GIL, so the threads decode in parallel.  Palette, 16-bit,
interlaced and JPEG files raise ``ValueError``; both datasets are 8-bit
PNG.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..utils.png import read_png_gray


def decode_gray_batch(
    paths: list[str], height: int, width: int, threads: int = 8, dtype=np.float32
) -> np.ndarray:
    """Decode same-sized images to (N, H, W, 1): uint8 with
    ``dtype=np.uint8`` (the files' own depth), else float32 in [0,1].  A
    file of another size raises ``IOError``."""
    out = np.empty((len(paths), height, width), np.uint8)
    with ThreadPoolExecutor(max_workers=max(1, min(threads, len(paths)))) as pool:
        for f in [pool.submit(read_png_gray, p, out[i]) for i, p in enumerate(paths)]:
            f.result()
    if np.dtype(dtype) == np.uint8:
        return out[..., None]
    return (out.astype(np.float32) / np.float32(255.0))[..., None]
