"""A JPEG reader on a compiled decoder of its own (``data/csrc/jpeg_decode.cpp``).

The port's machine has no imaging library and no libjpeg, so the decoder
is part of the port: baseline, extended 8-bit Huffman and progressive
files, restart intervals, any integral sampling, 1 or 3 components.  It
equals libjpeg-turbo under its defaults bit for bit (ISLOW IDCT, fancy
upsampling, its YCbCr tables), and so PIL's ``Image.open(p).convert("RGB")``
and ``convert("L")``: :func:`read_jpeg_gray` folds colour with PIL's
fixed-point luma.  The JAX package's libjpeg path asks libjpeg for gray
instead, which keeps the Y plane of a colour file (ROADMAP, "Found in the
reference").  EXIF orientation is not applied, as neither does.

A truncated or corrupt stream raises ``IOError``; arithmetic coding,
lossless and hierarchical files, 12-bit samples, 2 or 4 components (CMYK)
and a progressive file whose scans leave low coefficients incomplete
(where libjpeg would smooth the blocks) raise ``ValueError``.  The decoder
is built at first use with the system's C++ compiler
(``ops/cuda_build.py:load_host_library``); a failed build raises, and
nothing falls back.  ctypes releases the GIL, so threads decode in
parallel.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

_SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data", "csrc",
                       "jpeg_decode.cpp")
_U8P = ctypes.POINTER(ctypes.c_uint8)
_ERRLEN = 256
SOI = b"\xff\xd8"

_LIB = None


def _lib() -> ctypes.CDLL:
    """The compiled decoder, built at first use."""
    global _LIB
    if _LIB is None:
        from ..ops.cuda_build import load_host_library

        lib = load_host_library(_SOURCE)
        lib.jpeg_header.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_int32),
                                    ctypes.c_char_p, ctypes.c_int]
        lib.jpeg_header.restype = ctypes.c_int
        lib.jpeg_decode.argtypes = [ctypes.c_char_p, ctypes.c_int64, _U8P, ctypes.c_int32, ctypes.c_int32,
                                    ctypes.c_int32, ctypes.c_char_p, ctypes.c_int]
        lib.jpeg_decode.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _raise(status: int, err, path: str) -> None:
    msg = f"{path}: {err.value.decode(errors='replace')}"
    raise (ValueError(msg) if status == 2 else IOError(msg))


def _header(data: bytes, path: str) -> tuple[int, int, int]:
    info = (ctypes.c_int32 * 3)()
    err = ctypes.create_string_buffer(_ERRLEN)
    status = _lib().jpeg_header(data, len(data), info, err, _ERRLEN)
    if status:
        _raise(status, err, path)
    return info[0], info[1], info[2]


def decode_jpeg(data: bytes, path: str = "<bytes>", channels: int = 0, out: np.ndarray | None = None) -> np.ndarray:
    """Decode JPEG bytes to uint8 (H, W, C): C the file's components (1
    or 3) for ``channels=0``, else 1 (gray, PIL's ``convert("L")``) or 3
    (RGB, ``convert("RGB")``).  ``out`` may be a C-contiguous uint8
    buffer of that shape, or of (H, W) for gray, to write into; a size
    mismatch raises IOError."""
    if channels not in (0, 1, 3):
        raise ValueError(f"decode_jpeg: channels must be 0, 1 or 3, got {channels}")
    h, w, comps = _header(data, path)
    ch = channels or comps
    if out is None:
        out = np.empty((h, w, ch), np.uint8)
    elif out.shape[:2] != (h, w) or out.size != h * w * ch:
        raise IOError(f"{path}: size {(h, w)} != {out.shape[:2]}")
    if out.dtype != np.uint8 or not out.flags.c_contiguous:
        raise ValueError(f"decode_jpeg: out must be C-contiguous uint8, got {out.dtype}")
    err = ctypes.create_string_buffer(_ERRLEN)
    status = _lib().jpeg_decode(data, len(data), out.ctypes.data_as(_U8P), h, w, ch, err, _ERRLEN)
    if status:
        _raise(status, err, path)
    return out


def _read(path: str) -> bytes:
    with open(path, "rb") as fh:
        return fh.read()


def read_jpeg(path: str, channels: int = 0) -> np.ndarray:
    """Read a JPEG file as uint8 (H, W, C); see :func:`decode_jpeg`."""
    return decode_jpeg(_read(path), path, channels)


def read_jpeg_gray(path: str, out: np.ndarray | None = None) -> np.ndarray:
    """Read a JPEG file as (H, W) uint8 gray, as PIL's ``convert("L")``."""
    a = decode_jpeg(_read(path), path, 1, out)
    return a.reshape(a.shape[:2])


def jpeg_size(path: str) -> tuple[int, int]:
    """(height, width) from the frame header."""
    return _header(_read(path), path)[:2]
