"""A small PNG codec on the standard library (``zlib`` + ``struct``) and a
compiled row unfilter.

The port's demos, workloads and dataset loaders read and write PNGs with
it, so no imaging library is needed.  ``write_png`` writes 8-bit gray,
gray+alpha, RGB or RGBA with one of the five row filters on every row, or
with the cheapest filter per row ("adaptive", libpng's heuristic: the least
sum of |filtered byte| read as signed), so tests can write the files real
encoders write.  ``read_png`` reads 8-bit non-interlaced gray, gray+alpha,
RGB and RGBA; ``read_png_gray`` folds them to gray as PIL's
``convert("L")`` does.  Python's ``zlib`` inflates; the byte-serial row
unfilter and the gray fold run in ``data/csrc/png_unfilter.cpp``, built at
first use with the system's C++ compiler (``ops/cuda_build.py``).  A
failed build raises.  :func:`_unfilter` is the plain Python version of the
unfilter, which the tests hold the compiled one to.  Palette, 16-bit,
interlaced and JPEG files raise ``ValueError``; a truncated or corrupt
stream raises ``IOError``.
"""

from __future__ import annotations

import ctypes
import os
import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 4: 2, 2: 3, 6: 4}  # PNG colour type -> samples per pixel
_COLOR_TYPE = {1: 0, 2: 4, 3: 2, 4: 6}
FILTER_TYPES = (0, 1, 2, 3, 4, "adaptive")
_SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data", "csrc",
                       "png_unfilter.cpp")
_U8P = ctypes.POINTER(ctypes.c_uint8)


def _chunk(tag: bytes, data: bytes) -> bytes:
    body = tag + data
    return struct.pack(">I", len(data)) + body + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF)


def _paeth_np(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _filter_rows(rows: np.ndarray, bpp: int, filter_type) -> np.ndarray:
    """(H, stride) uint8 scanlines -> (H, 1 + stride) filtered rows, each
    led by its filter type byte."""
    x = rows.astype(np.int16)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, bpp:] = x[:-1, :-bpp]
    preds = (np.zeros_like(x), a, b, (a + b) >> 1, _paeth_np(a, b, c))
    filtered = np.stack([(x - p) & 0xFF for p in preds])  # (5, H, stride)
    if filter_type == "adaptive":
        cost = np.abs(filtered.astype(np.uint8).view(np.int8).astype(np.int32)).sum(axis=2)  # (5, H)
        types = np.argmin(cost, axis=0)
    elif filter_type in range(5):
        types = np.full(len(rows), filter_type)
    else:
        raise ValueError(f"write_png: filter_type must be one of {FILTER_TYPES}, got {filter_type!r}")
    chosen = filtered[types, np.arange(len(rows))]
    return np.concatenate([types[:, None], chosen], axis=1).astype(np.uint8)


def write_png(path: str, img: np.ndarray, filter_type=0) -> None:
    """Write an (H, W) or (H, W, 1|2|3|4) image as an 8-bit PNG with row
    filter ``filter_type`` (0-4 or "adaptive"); a float image is taken as
    [0,1]."""
    a = np.asarray(img)
    if a.dtype != np.uint8:
        a = (np.clip(a, 0.0, 1.0) * 255.0).astype(np.uint8)
    if a.ndim == 2:
        a = a[..., None]
    if a.ndim != 3 or a.shape[-1] not in _COLOR_TYPE:
        raise ValueError(f"write_png: expected (H, W) or (H, W, 1-4), got {a.shape}")
    h, w, ch = a.shape
    raw = _filter_rows(a.reshape(h, w * ch), ch, filter_type) if h and w else np.zeros((h, 1), np.uint8)
    with open(path, "wb") as fh:
        fh.write(_SIGNATURE)
        fh.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPE[ch], 0, 0, 0)))
        fh.write(_chunk(b"IDAT", zlib.compress(raw.tobytes())))
        fh.write(_chunk(b"IEND", b""))


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(ftype: int, line: np.ndarray, prior: np.ndarray, bpp: int) -> np.ndarray:
    """One scanline's bytes after undoing filter ``ftype`` (PNG spec §9):
    the plain version of ``png_unfilter``."""
    if ftype == 0:
        return line
    if ftype == 2:  # Up
        return (line.astype(np.uint16) + prior).astype(np.uint8)
    if ftype == 1:  # Sub: a running sum along each byte of the pixel, mod 256
        return (np.cumsum(line.reshape(-1, bpp).astype(np.int64), axis=0) % 256).astype(np.uint8).reshape(-1)
    if ftype not in (3, 4):
        raise ValueError(f"read_png: unknown filter type {ftype}")
    out = bytearray(line.tobytes())
    up = prior.tobytes()
    for i in range(len(out)):
        left = out[i - bpp] if i >= bpp else 0
        if ftype == 3:  # Average
            out[i] = (out[i] + ((left + up[i]) >> 1)) & 0xFF
        else:  # Paeth
            upleft = up[i - bpp] if i >= bpp else 0
            out[i] = (out[i] + _paeth(left, up[i], upleft)) & 0xFF
    return np.frombuffer(bytes(out), np.uint8)


_LIB = None


def _lib() -> ctypes.CDLL:
    """The compiled unfilter, built at first use."""
    global _LIB
    if _LIB is None:
        from ..ops.cuda_build import load_host_library

        lib = load_host_library(_SOURCE)
        lib.png_unfilter.argtypes = [_U8P, _U8P, ctypes.c_int64, ctypes.c_int64, ctypes.c_int]
        lib.png_unfilter.restype = ctypes.c_int
        lib.png_to_gray.argtypes = [_U8P, _U8P, ctypes.c_int64, ctypes.c_int]
        lib.png_to_gray.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(_U8P)


def unfilter_rows(raw: np.ndarray, bpp: int, out: np.ndarray | None = None) -> np.ndarray:
    """(H, 1 + stride) inflated rows -> (H, stride) uint8 with the filters
    undone, by the compiled helper; ``out`` may be a C-contiguous (H,
    stride) uint8 buffer to write into."""
    h, stride = raw.shape[0], raw.shape[1] - 1
    raw = np.ascontiguousarray(raw, np.uint8)
    if out is None:
        out = np.empty((h, stride), np.uint8)
    if out.shape != (h, stride) or out.dtype != np.uint8 or not out.flags.c_contiguous:
        raise ValueError(f"unfilter_rows: out must be C-contiguous uint8 {(h, stride)}, got {out.dtype} {out.shape}")
    bad = _lib().png_unfilter(_ptr(raw), _ptr(out), h, stride, bpp)
    if bad:
        raise IOError(f"PNG row {bad - 1} has filter type {raw[bad - 1, 0]}, not 0-4")
    return out


def _read_header(data: bytes, path: str) -> tuple[int, int, int, int, int]:
    """(width, height, bit depth, colour type, interlace) from the IHDR
    chunk, which the spec puts first; raises ValueError for a file that is
    not a PNG."""
    if data[:2] == b"\xff\xd8":
        raise ValueError(f"{path} is a JPEG: the port decodes PNG only (no libjpeg is assumed; ROADMAP)")
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path} is not a PNG file")
    if data[12:16] != b"IHDR":
        raise IOError(f"{path}: the PNG does not start with an IHDR chunk")
    w, h, depth, color, _, _, interlace = struct.unpack(">IIBBBBB", data[16:29])
    return w, h, depth, color, interlace


def png_size(path: str) -> tuple[int, int]:
    """(height, width) of a PNG, from its IHDR chunk alone."""
    with open(path, "rb") as fh:
        w, h = _read_header(fh.read(29), path)[:2]
    return h, w


def _decode(path: str) -> tuple[np.ndarray, int, int, int]:
    """(inflated rows (H, 1 + W·channels), H, W, channels) of an 8-bit
    non-interlaced gray/gray+alpha/RGB/RGBA PNG."""
    with open(path, "rb") as fh:
        data = fh.read()
    w, h, depth, color, interlace = _read_header(data, path)
    if depth != 8 or color not in _CHANNELS or interlace:
        kind = f"colour type {color}" + (" (palette)" if color == 3 else "")
        raise ValueError(f"{path}: only 8-bit non-interlaced gray, gray+alpha, RGB and RGBA PNGs are read "
                         f"(this one: bit depth {depth}, {kind}, interlace {interlace})")
    pos, idat = 8, []
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        tag = data[pos + 4 : pos + 8]
        if tag == b"IDAT":
            idat.append(data[pos + 8 : pos + 8 + length])
        elif tag == b"IEND":
            break
        pos += 12 + length
    ch = _CHANNELS[color]
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as err:
        raise IOError(f"{path}: corrupt image data ({err})") from None
    if len(raw) != h * (w * ch + 1):
        raise IOError(f"{path}: {len(raw)} bytes of image data, {h * (w * ch + 1)} expected")
    return np.frombuffer(raw, np.uint8).reshape(h, w * ch + 1), h, w, ch


def read_png(path: str) -> np.ndarray:
    """Read an 8-bit non-interlaced PNG as uint8 (H, W, channels)."""
    raw, h, w, ch = _decode(path)
    return unfilter_rows(raw, ch).reshape(h, w, ch)


def read_png_gray(path: str, out: np.ndarray | None = None) -> np.ndarray:
    """Read an 8-bit PNG as (H, W) uint8 gray, as PIL's ``convert("L")``
    gives it (alpha dropped; colour by ITU-R 601-2 luma, fixed point);
    ``out`` may be a C-contiguous (H, W) uint8 buffer of the file's size
    to write into, else a size mismatch raises IOError."""
    raw, h, w, ch = _decode(path)
    if out is None:
        out = np.empty((h, w), np.uint8)
    if out.shape != (h, w):
        raise IOError(f"{path}: size {(h, w)} != {out.shape}")
    if ch == 1:
        return unfilter_rows(raw, 1, out)
    pix = unfilter_rows(raw, ch)
    if not out.flags.c_contiguous or out.dtype != np.uint8:
        raise ValueError(f"read_png_gray: out must be C-contiguous uint8, got {out.dtype}")
    _lib().png_to_gray(_ptr(pix), _ptr(out), h * w, ch)
    return out
