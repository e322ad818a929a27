"""A small PNG codec on the standard library (``zlib`` + ``struct``).

The port's demos and workloads read and write PNGs with it, so no imaging
library is needed.  ``write_png`` writes 8-bit gray, RGB or RGBA with filter
type 0.  ``read_png`` reads 8-bit non-interlaced gray, gray+alpha, RGB and
RGBA with any of the five filter types; palette, 16-bit and interlaced
files raise.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 4: 2, 2: 3, 6: 4}  # PNG colour type -> samples per pixel
_COLOR_TYPE = {1: 0, 2: 4, 3: 2, 4: 6}


def _chunk(tag: bytes, data: bytes) -> bytes:
    body = tag + data
    return struct.pack(">I", len(data)) + body + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF)


def write_png(path: str, img: np.ndarray) -> None:
    """Write an (H, W) or (H, W, 1|2|3|4) image as an 8-bit PNG; a float
    image is taken as [0,1]."""
    a = np.asarray(img)
    if a.dtype != np.uint8:
        a = (np.clip(a, 0.0, 1.0) * 255.0).astype(np.uint8)
    if a.ndim == 2:
        a = a[..., None]
    if a.ndim != 3 or a.shape[-1] not in _COLOR_TYPE:
        raise ValueError(f"write_png: expected (H, W) or (H, W, 1-4), got {a.shape}")
    h, w, ch = a.shape
    raw = b"".join(b"\x00" + a[r].tobytes() for r in range(h))
    with open(path, "wb") as fh:
        fh.write(_SIGNATURE)
        fh.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPE[ch], 0, 0, 0)))
        fh.write(_chunk(b"IDAT", zlib.compress(raw)))
        fh.write(_chunk(b"IEND", b""))


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(ftype: int, line: np.ndarray, prior: np.ndarray, bpp: int) -> np.ndarray:
    """One scanline's bytes after undoing filter ``ftype`` (PNG spec §9)."""
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


def read_png(path: str) -> np.ndarray:
    """Read an 8-bit non-interlaced PNG as uint8 (H, W, channels)."""
    with open(path, "rb") as fh:
        data = fh.read()
    if data[:8] != _SIGNATURE:
        raise ValueError(f"read_png: {path} is not a PNG file")
    pos, idat, header = 8, [], None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        tag, body = data[pos + 4 : pos + 8], data[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if header is None:
        raise ValueError(f"read_png: {path} has no IHDR chunk")
    w, h, depth, color, _, _, interlace = header
    if depth != 8 or color not in _CHANNELS or interlace:
        raise ValueError(f"read_png: {path}: only 8-bit non-interlaced gray/RGB(A) PNGs are read "
                         f"(bit depth {depth}, colour type {color}, interlace {interlace})")
    bpp = _CHANNELS[color]
    stride = w * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, stride + 1)
    rows, prior = [], np.zeros(stride, np.uint8)
    for r in range(h):
        prior = _unfilter(int(raw[r, 0]), raw[r, 1:], prior, bpp)
        rows.append(prior)
    return np.stack(rows).reshape(h, w, bpp) if h else np.zeros((0, w, bpp), np.uint8)
