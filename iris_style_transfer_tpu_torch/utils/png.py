"""A small PNG codec on the standard library (``zlib`` + ``struct``) and a
compiled row unfilter.

The port's demos, workloads and dataset loaders read and write PNGs with
it, so no imaging library is needed.  ``write_png`` writes 8-bit gray,
gray+alpha, RGB or RGBA with one of the five row filters on every row, or
with the cheapest filter per row ("adaptive", libpng's heuristic: the least
sum of |filtered byte| read as signed), so tests can write the files real
encoders write.  ``read_png`` reads every PNG form, as libpng does under
the JAX package's native loader: gray at 1, 2, 4, 8 and 16 bits, palette
at 1, 2, 4 and 8 bits (colours through PLTE, tRNS dropped), gray+alpha,
RGB and RGBA at 8 and 16 bits, non-interlaced or Adam7.  Samples come out
8-bit: 1/2/4-bit gray is scaled as ``png_set_expand_gray_1_2_4_to_8``
does, 16-bit samples keep their high byte as ``png_set_strip_16`` does
(PIL's ``convert("L")`` of a 16-bit gray file clips at 255 instead;
ROADMAP, "Found in the reference").  ``read_png_gray`` folds colour to
gray as PIL's ``convert("L")`` does.  Python's ``zlib`` inflates; the
byte-serial row unfilter (each Adam7 pass on its own) and the gray fold
run in ``data/csrc/png_unfilter.cpp``, built at first use with the
system's C++ compiler (``ops/cuda_build.py``).  A failed build raises.
:func:`_unfilter` is the plain Python version of the unfilter, which the
tests hold the compiled one to.  A file that is not a PNG raises
``ValueError``; a truncated or corrupt stream raises ``IOError``.
"""

from __future__ import annotations

import ctypes
import os
import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 4: 2, 2: 3, 6: 4, 3: 1}  # PNG colour type -> samples per pixel
_DEPTHS = {0: (1, 2, 4, 8, 16), 3: (1, 2, 4, 8), 2: (8, 16), 4: (8, 16), 6: (8, 16)}
# Adam7: (first column, first row, column step, row step) of each pass
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
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
    not a PNG and IOError for a header no decoder reads."""
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path} is not a PNG file")
    if data[12:16] != b"IHDR":
        raise IOError(f"{path}: the PNG does not start with an IHDR chunk")
    w, h, depth, color, _, _, interlace = struct.unpack(">IIBBBBB", data[16:29])
    if depth not in _DEPTHS.get(color, ()) or interlace > 1:
        raise IOError(f"{path}: bad IHDR (bit depth {depth}, colour type {color}, interlace {interlace})")
    return w, h, depth, color, interlace


def png_size(path: str) -> tuple[int, int]:
    """(height, width) of a PNG, from its IHDR chunk alone."""
    with open(path, "rb") as fh:
        w, h = _read_header(fh.read(29), path)[:2]
    return h, w


def _stride(w: int, ch: int, depth: int) -> int:
    return (w * ch * depth + 7) // 8


class _Png:
    """A parsed PNG: its header, inflated image data and palette."""

    def __init__(self, path: str):
        with open(path, "rb") as fh:
            data = fh.read()
        self.w, self.h, self.depth, self.color, self.interlace = _read_header(data, path)
        self.ch = _CHANNELS[self.color]
        pos, idat, self.plte = 8, [], None
        while pos + 8 <= len(data):
            (length,) = struct.unpack(">I", data[pos : pos + 4])
            tag = data[pos + 4 : pos + 8]
            if tag == b"IDAT":
                idat.append(data[pos + 8 : pos + 8 + length])
            elif tag == b"PLTE":
                self.plte = np.frombuffer(data[pos + 8 : pos + 8 + length - length % 3], np.uint8).reshape(-1, 3)
            elif tag == b"IEND":
                break
            pos += 12 + length
        if self.color == 3 and self.plte is None:
            raise IOError(f"{path}: a palette PNG without a PLTE chunk")
        try:
            self.raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
        except zlib.error as err:
            raise IOError(f"{path}: corrupt image data ({err})") from None
        want = sum(ph * (1 + _stride(pw, self.ch, self.depth)) for _, _, _, _, ph, pw in self.passes())
        if len(self.raw) != want:
            raise IOError(f"{path}: {len(self.raw)} bytes of image data, {want} expected")

    def passes(self) -> list[tuple[int, int, int, int, int, int]]:
        """(first row, first column, row step, column step, rows, columns)
        of each non-empty pass; one pass for a non-interlaced file."""
        out = []
        for x0, y0, dx, dy in _ADAM7 if self.interlace else ((0, 0, 1, 1),):
            ph, pw = -(-(self.h - y0) // dy), -(-(self.w - x0) // dx)
            if ph > 0 and pw > 0:
                out.append((y0, x0, dy, dx, ph, pw))
        return out

    @property
    def plain8(self) -> bool:
        """8-bit, non-interlaced, no palette: the unfiltered rows are the pixels."""
        return self.depth == 8 and not self.interlace and self.color != 3

    def pixels(self) -> np.ndarray:
        """(H, W, C) uint8: 8-bit samples, palettes expanded to RGB (C 3),
        every pass in its place."""
        if self.plain8:
            return unfilter_rows(self.raw.reshape(self.h, 1 + self.w * self.ch), self.ch).reshape(
                self.h, self.w, self.ch)
        out_ch = 3 if self.color == 3 else self.ch
        img = np.empty((self.h, self.w, out_ch), np.uint8)
        bpp = max(1, self.ch * self.depth // 8)
        off = 0
        for y0, x0, dy, dx, ph, pw in self.passes():
            stride = _stride(pw, self.ch, self.depth)
            rows = unfilter_rows(self.raw[off : off + ph * (1 + stride)].reshape(ph, 1 + stride), bpp)
            off += ph * (1 + stride)
            img[y0::dy, x0::dx] = self._samples(rows, pw)
        return img

    def _samples(self, rows: np.ndarray, pw: int) -> np.ndarray:
        """A pass's unfiltered rows -> (rows, pw, C) 8-bit samples."""
        n = len(rows)
        if self.depth == 16:  # png_set_strip_16: the high byte
            s = rows[:, 0::2]
        elif self.depth < 8:
            bits = np.unpackbits(rows, axis=1)[:, : pw * self.depth].reshape(n, pw, self.depth)
            s = (bits.astype(np.uint8) << np.arange(self.depth - 1, -1, -1, dtype=np.uint8)).sum(axis=2, dtype=np.uint8)
            if self.color == 0:  # png_set_expand_gray_1_2_4_to_8
                s = s * np.uint8(255 // (2**self.depth - 1))
        else:
            s = rows
        s = s.reshape(n, pw, self.ch)
        if self.color == 3:  # PLTE colours; an index past the palette reads black
            pal, plte = np.zeros((256, 3), np.uint8), self.plte[:256]
            pal[: len(plte)] = plte
            s = pal[s[..., 0]]
        return s


def read_png(path: str) -> np.ndarray:
    """Read a PNG as uint8 (H, W, C): C the file's samples per pixel (1
    gray, 2 gray+alpha, 3 RGB or palette, 4 RGBA), 8-bit."""
    return _Png(path).pixels()


def read_png_gray(path: str, out: np.ndarray | None = None) -> np.ndarray:
    """Read a PNG as (H, W) uint8 gray, as PIL's ``convert("L")`` gives it
    (alpha dropped; colour by ITU-R 601-2 luma, fixed point; 16-bit
    samples by their high byte); ``out`` may be a C-contiguous (H, W)
    uint8 buffer of the file's size to write into, else a size mismatch
    raises IOError."""
    f = _Png(path)
    h, w = f.h, f.w
    if out is None:
        out = np.empty((h, w), np.uint8)
    if out.shape != (h, w):
        raise IOError(f"{path}: size {(h, w)} != {out.shape}")
    if not out.flags.c_contiguous or out.dtype != np.uint8:
        raise ValueError(f"read_png_gray: out must be C-contiguous uint8, got {out.dtype}")
    if f.plain8 and f.ch == 1:
        return unfilter_rows(f.raw.reshape(h, 1 + w), 1, out)
    pix = np.ascontiguousarray(f.pixels())
    _lib().png_to_gray(_ptr(pix), _ptr(out), h * w, pix.shape[-1])
    return out
