"""One entry for every image reader of the port: PNG or JPEG by magic bytes.

Counterpart of the dispatch in the JAX package's
``native/ist_loader.cpp:istl_decode_gray_u8`` (a PNG signature or a JPEG
SOI marker; anything else fails): the dataset loaders, the 2020 IST
main's style frame and both demos read through here.  PNGs go to
``utils/png.py`` and JPEGs to ``utils/jpeg.py``; both follow PIL's
``Image.open(p).convert("L" | "RGB")``, apart from 16-bit gray PNGs,
which keep their high byte as libpng does.  A file of another format
raises ``ValueError``.
"""

from __future__ import annotations

import numpy as np

from . import jpeg, png

_PNG_MAGIC = b"\x89P"


def _kind(path: str) -> str:
    with open(path, "rb") as fh:
        magic = fh.read(2)
    if magic == _PNG_MAGIC:
        return "png"
    if magic == jpeg.SOI:
        return "jpeg"
    raise ValueError(f"{path} is neither a PNG nor a JPEG file")


def read_image(path: str, channels: int = 0) -> np.ndarray:
    """uint8 (H, W, C).  ``channels=0``: the file's own samples (PNG: 1
    gray, 2 gray+alpha, 3 RGB or palette, 4 RGBA; JPEG: 1 or 3); 3: RGB
    as PIL's ``convert("RGB")`` (gray repeated, alpha dropped).  Gray is
    :func:`read_image_gray`."""
    if channels not in (0, 3):
        raise ValueError(f"read_image: channels must be 0 or 3, got {channels}")
    if _kind(path) == "jpeg":
        return jpeg.read_jpeg(path, channels)
    a = png.read_png(path)
    if channels == 3:
        a = np.repeat(a[..., :1], 3, axis=-1) if a.shape[-1] <= 2 else np.ascontiguousarray(a[..., :3])
    return a


def read_image_gray(path: str, out: np.ndarray | None = None) -> np.ndarray:
    """(H, W) uint8 gray, as PIL's ``convert("L")``; ``out`` may be a
    C-contiguous (H, W) uint8 buffer of the file's size to write into, else
    a size mismatch raises IOError."""
    if _kind(path) == "jpeg":
        return jpeg.read_jpeg_gray(path, out)
    return png.read_png_gray(path, out)


def image_size(path: str) -> tuple[int, int]:
    """(height, width) from the file's header."""
    return jpeg.jpeg_size(path) if _kind(path) == "jpeg" else png.png_size(path)
