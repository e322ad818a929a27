"""Threaded frame decode for the host input pipeline.

Counterpart of ``iris_style_transfer_tpu/data/native_loader.py``, whose
libpng/libjpeg library (``native/ist_loader.cpp``) the port does not
assume on its machine.  :func:`decode_gray_batch` decodes same-sized PNGs
and JPEGs on a thread pool through ``utils/decode.py``, which picks the
format by magic bytes as ``ist_loader.cpp`` does: for a PNG, Python's
``zlib`` inflates and ``data/csrc/png_unfilter.cpp`` undoes the row
filters; a JPEG goes through ``data/csrc/jpeg_decode.cpp``.  Colour folds
to gray as PIL's ``convert("L")`` does.  The compiled parts release the
GIL, so the threads decode in parallel.  Every PNG form and baseline and
progressive JPEG read; a file of another format raises ``ValueError``, as
do the JPEG forms ``utils/jpeg.py`` lists.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..utils import jpeg, png
from ..utils.decode import read_image_gray


def available() -> bool:
    """Whether the decode helpers (``data/csrc/png_unfilter.cpp`` and
    ``jpeg_decode.cpp``) build and load on this machine;
    :func:`decode_gray_batch` needs them and has no fallback."""
    try:
        png._lib()
        jpeg._lib()
    except (RuntimeError, OSError):  # no compiler, a failed build, an unloadable library
        return False
    return True


def decode_gray_batch(
    paths: list[str], height: int, width: int, threads: int = 8, dtype=np.float32
) -> np.ndarray:
    """Decode same-sized images to (N, H, W, 1): uint8 with
    ``dtype=np.uint8`` (the files' own depth), else float32 in [0,1].  A
    file of another size raises ``IOError``."""
    out = np.empty((len(paths), height, width), np.uint8)
    with ThreadPoolExecutor(max_workers=max(1, min(threads, len(paths)))) as pool:
        for f in [pool.submit(read_image_gray, p, out[i]) for i, p in enumerate(paths)]:
            f.result()
    if np.dtype(dtype) == np.uint8:
        return out[..., None]
    return (out.astype(np.float32) / np.float32(255.0))[..., None]
