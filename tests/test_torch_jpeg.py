"""The port's JPEG decoder (``utils/jpeg.py``, ``data/csrc/jpeg_decode.cpp``)
against PIL and the JAX package's ``decode_gray_batch``, on the CPU.

Every comparison with PIL is exact (0 levels): the decoder follows
libjpeg-turbo's ISLOW IDCT, fancy upsampling and YCbCr tables, which PIL
runs under its defaults.  The grid: modes L and RGB, subsampling 4:4:4,
4:2:2 and 4:2:0, quality 10, 50, 95 and 100, progressive and optimized
tables on and off, sizes 1x1, 7x9, 17x33 and 400x640; then restart
intervals, RGB-coded files (``keep_rgb``), 16-bit quantization tables, and
files of other sampling factors (h1v2, 4:4:0, 4:1:1, 3x1, 4x4 and more)
written by a small baseline encoder here, as PIL writes only three.

Against the JAX function: its PIL path equals the port everywhere.  Its
libjpeg path asks libjpeg for gray, which keeps a colour file's Y plane:
on gray files it equals the port; on colour files it equals the port at
every pixel whose R, G and B all lie inside (0, 255), and parts from it
where a channel clips, because PIL's luma of the clipped RGB is no longer
the Y it came from (ROADMAP, "Found in the reference").
"""

import hashlib
import json
import os
import struct

import numpy as np
import pytest
from PIL import Image, ImageFile

from iris_style_transfer_tpu.data import native_loader as jnl

from iris_style_transfer_tpu_torch.data import native_loader as tnl
from iris_style_transfer_tpu_torch.utils import decode, jpeg

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_fixtures")
SIZES = [(1, 1), (7, 9), (17, 33), (400, 640)]
QUALITIES = (10, 50, 95, 100)


@pytest.fixture(autouse=True)
def _big_pil_buffer(monkeypatch):
    # PIL writes progressive and optimized files in one buffer of MAXBLOCK
    # bytes; a noisy 400x640 colour frame at quality 100 needs more
    monkeypatch.setattr(ImageFile, "MAXBLOCK", 1 << 24)


def _image(h: int, w: int, ch: int, seed: int) -> np.ndarray:
    """Smooth waves under noise: structure for the IDCT, edges for the
    upsampling, and clipped channels."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = np.stack([np.sin(yy / 7 + c) * 80 + np.cos(xx / 5 - c) * 60 + 128 for c in range(ch)], -1)
    a = np.clip(base + rng.normal(0, 20, (h, w, ch)), 0, 255).astype(np.uint8)
    return a[..., 0] if ch == 1 else a


def _save(path, a: np.ndarray, **opts) -> str:
    Image.fromarray(a, "L" if a.ndim == 2 else "RGB").save(path, "JPEG", **opts)
    return str(path)


def _assert_like_pil(path: str) -> None:
    """read_jpeg in every channel mode against PIL, exactly."""
    with Image.open(path) as im:
        own = np.asarray(im)
        rgb = np.asarray(im.convert("RGB"))
        gray = np.asarray(im.convert("L"))
    np.testing.assert_array_equal(jpeg.read_jpeg(path).reshape(own.shape), own)
    np.testing.assert_array_equal(jpeg.read_jpeg(path, 3), rgb)
    np.testing.assert_array_equal(jpeg.read_jpeg_gray(path), gray)
    assert jpeg.jpeg_size(path) == gray.shape


@pytest.mark.parametrize("progressive", [False, True], ids=["baseline", "progressive"])
@pytest.mark.parametrize("hw", SIZES, ids=[f"{h}x{w}" for h, w in SIZES])
@pytest.mark.parametrize("mode,subsampling", [("L", 0), ("RGB", 0), ("RGB", 1), ("RGB", 2)],
                         ids=["L", "RGB-444", "RGB-422", "RGB-420"])
def test_jpeg_bit_exact_to_pil(tmp_path, mode, subsampling, hw, progressive):
    """Every quality, with and without optimized Huffman tables."""
    a = _image(*hw, 1 if mode == "L" else 3, seed=hw[0] + subsampling)
    for q in QUALITIES:
        for optimize in (False, True):
            p = _save(tmp_path / f"q{q}{optimize:d}.jpg", a, quality=q, subsampling=subsampling,
                      progressive=progressive, optimize=optimize)
            _assert_like_pil(p)


def _segments(data: bytes) -> list[tuple[int, bytes]]:
    """(marker, body) of each marker segment up to the first SOS."""
    out, pos = [], 2
    while data[pos + 1] != 0xDA:
        marker, (length,) = data[pos + 1], struct.unpack(">H", data[pos + 2 : pos + 4])
        out.append((marker, data[pos + 4 : pos + 2 + length]))
        pos += 2 + length
    return out


@pytest.mark.parametrize("progressive", [False, True], ids=["baseline", "progressive"])
@pytest.mark.parametrize("case", ["restart_blocks", "restart_rows", "keep_rgb", "dqt16", "dqt16_flat",
                                  "exif_comment"])
def test_jpeg_markers_and_tables(tmp_path, case, progressive):
    """Restart intervals (DRI + RST0-7), RGB-coded files (Adobe transform
    0, no YCbCr conversion), 16-bit DQT tables, and an EXIF APP1 with
    orientation 6 plus a COM segment (skipped: neither PIL's Image.open nor
    libjpeg rotates), each checked present in the file and decoded
    exactly; the restart numbers wrap past RST7."""
    a = _image(120, 163, 3, seed=5)
    opts = {"progressive": progressive}
    if case == "restart_blocks":
        opts.update(restart_marker_blocks=3, subsampling=2)
    elif case == "restart_rows":
        opts.update(restart_marker_rows=1, subsampling=1)
    elif case == "keep_rgb":
        opts.update(keep_rgb=True, subsampling=0)
    elif case == "dqt16":
        opts.update(qtables=[list(range(1, 65)), [300 + 7 * i for i in range(64)]])
    elif case == "exif_comment":
        exif = Image.Exif()
        exif[0x0112] = 6  # Orientation: rotate 90 degrees clockwise to view
        opts.update(exif=exif.tobytes(), comment=b"a comment segment")
    else:
        opts.update(qtables=[[2000 + i for i in range(64)]] * 2, subsampling=2)
    p = _save(tmp_path / "m.jpg", a, **opts)
    data = open(p, "rb").read()
    seg = _segments(data)
    if case.startswith("restart"):
        assert any(m == 0xDD for m, _ in seg) and b"\xff\xd0" in data and b"\xff\xd7" in data
    elif case == "exif_comment":
        assert any(m == 0xE1 and b[:4] == b"Exif" for m, b in seg) and any(m == 0xFE for m, _ in seg)
        assert jpeg.read_jpeg(p).shape == (120, 163, 3)  # not rotated
    elif case == "keep_rgb":
        adobe = [b for m, b in seg if m == 0xEE]
        assert adobe and adobe[0][:5] == b"Adobe" and adobe[0][11] == 0
        assert not any(m == 0xE0 for m, _ in seg)  # no JFIF marker, which would mean YCbCr
    else:
        assert any(m == 0xDB and b[0] >> 4 == 1 for m, b in seg)  # a table of 16-bit entries
    _assert_like_pil(p)


# --- a small baseline encoder, for sampling factors PIL does not write ---

_ZIGZAG = np.array([0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48, 41, 34, 27,
                    20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51, 58,
                    59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])
_DCT = np.array([[np.sqrt((1 if u == 0 else 2) / 8) * np.cos((2 * x + 1) * u * np.pi / 16) for x in range(8)]
                 for u in range(8)])


def _codes(bits_vals: bytes) -> dict:
    """symbol -> (code, length) of a DHT table body (class/index byte first)."""
    counts, vals = bits_vals[1:17], bits_vals[17:]
    out, code, k = {}, 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            out[vals[k]] = (code, length)
            code, k = code + 1, k + 1
        code <<= 1
    return out


class _BitWriter:
    def __init__(self):
        self.out, self.acc, self.n = bytearray(), 0, 0

    def put(self, value: int, length: int) -> None:
        self.acc, self.n = (self.acc << length) | (value & ((1 << length) - 1)), self.n + length
        while self.n >= 8:
            byte = (self.acc >> (self.n - 8)) & 0xFF
            self.out += b"\xff\x00" if byte == 0xFF else bytes([byte])
            self.n -= 8

    def flush(self) -> bytes:
        if self.n:
            self.put(0x7F, 8 - self.n)  # pad with ones
        return bytes(self.out)


def _category(v: int) -> tuple[int, int]:
    s = abs(v).bit_length()
    return s, (v if v >= 0 else v + (1 << s) - 1)


def _encode(planes: list, factors: list, height: int, width: int, tables: list) -> bytes:
    """A baseline JPEG (one interleaved scan, flat quantization 2, the given
    DHT segment bodies) of component planes already at their sampled size."""
    hmax, vmax = max(f[0] for f in factors), max(f[1] for f in factors)
    mcux, mcuy = -(-width // (8 * hmax)), -(-height // (8 * vmax))
    q = 2
    dc_codes, ac_codes = _codes(tables[0]), _codes(tables[1])
    blocks = []
    for plane, (h, v) in zip(planes, factors):
        ph, pw = mcuy * v * 8, mcux * h * 8
        full = np.pad(plane.astype(np.float64), ((0, ph - plane.shape[0]), (0, pw - plane.shape[1])), mode="edge")
        coef = np.einsum("ux,bxy,vy->buv", _DCT, full.reshape(ph // 8, 8, pw // 8, 8).transpose(0, 2, 1, 3)
                         .reshape(-1, 8, 8) - 128, _DCT)
        blocks.append(np.round(coef / q).astype(int).reshape(ph // 8, pw // 8, 64)[..., _ZIGZAG])
    w = _BitWriter()
    pred = [0] * len(planes)
    for my in range(mcuy):
        for mx in range(mcux):
            for c, (h, v) in enumerate(factors):
                for by in range(v):
                    for bx in range(h):
                        blk = blocks[c][my * v + by, mx * h + bx]
                        s, bits = _category(int(blk[0]) - pred[c])
                        pred[c] = int(blk[0])
                        w.put(*dc_codes[s])
                        w.put(bits, s)
                        run = 0
                        for k in range(1, 64):
                            if blk[k] == 0:
                                run += 1
                                continue
                            while run > 15:
                                w.put(*ac_codes[0xF0])
                                run -= 16
                            s, bits = _category(int(blk[k]))
                            w.put(*ac_codes[(run << 4) | s])
                            w.put(bits, s)
                            run = 0
                        if run:
                            w.put(*ac_codes[0x00])

    def seg(marker: int, body: bytes) -> bytes:
        return bytes([0xFF, marker]) + struct.pack(">H", len(body) + 2) + body

    n = len(planes)
    sof = struct.pack(">BHHB", 8, height, width, n) + b"".join(
        bytes([c + 1, (h << 4) | v, 0]) for c, (h, v) in enumerate(factors))
    sos = bytes([n]) + b"".join(bytes([c + 1, 0x00]) for c in range(n)) + bytes([0, 63, 0])
    return (b"\xff\xd8" + seg(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
            + seg(0xDB, bytes([0]) + bytes([q] * 64)) + seg(0xC0, sof)
            + seg(0xC4, tables[0]) + seg(0xC4, tables[1]) + seg(0xDA, sos) + w.flush() + b"\xff\xd9")


@pytest.fixture(scope="module")
def standard_tables(tmp_path_factory) -> list:
    """The luminance DC and AC Huffman tables (Annex K) of a PIL file."""
    p = _save(tmp_path_factory.mktemp("dht") / "t.jpg", _image(8, 8, 1, 0), quality=100)
    return [b for m, b in _segments(open(p, "rb").read()) if m == 0xC4][:2]


SAMPLINGS = {
    "h1v2": ((1, 2), (1, 1), (1, 1)), "440-in-2x2": ((2, 2), (1, 2), (1, 2)), "411": ((4, 1), (1, 1), (1, 1)),
    "3x1": ((3, 1), (1, 1), (1, 1)), "4x2": ((4, 2), (1, 1), (1, 1)), "1x4": ((1, 4), (1, 2), (1, 1)),
    "chroma-larger": ((1, 1), (2, 2), (1, 1)), "h2v1-mixed": ((2, 1), (1, 1), (2, 1)),
    "mcu-of-21-blocks": ((4, 4), (1, 1), (2, 2)),
}


@pytest.mark.parametrize("factors", list(SAMPLINGS.values()), ids=list(SAMPLINGS))
@pytest.mark.parametrize("hw", [(5, 3), (33, 47)], ids=["5x3", "33x47"])
def test_jpeg_any_sampling_factors_bit_exact(tmp_path, standard_tables, factors, hw):
    """Sampling factors PIL cannot write: the fancy h1v2 and h2v2/h2v1 filters
    on any component whose ratio to the largest is 2, the box elsewhere
    (and for a component at most 2 samples wide), against PIL; an MCU of
    more than 10 blocks fails in both, as libjpeg refuses it."""
    height, width = hw
    hmax, vmax = max(f[0] for f in factors), max(f[1] for f in factors)
    rgb = _image(height, width, 3, seed=height)
    ycc = np.asarray(Image.fromarray(rgb).convert("YCbCr")).astype(np.float64)
    planes = []
    for c, (h, v) in enumerate(factors):
        dh, dw = -(-height * v // vmax), -(-width * h // hmax)
        planes.append(np.asarray(Image.fromarray(ycc[..., c].astype(np.uint8)).resize((dw, dh), Image.BOX)))
    p = tmp_path / "s.jpg"
    p.write_bytes(_encode(planes, list(factors), height, width, standard_tables))
    if sum(h * v for h, v in factors) > 10:
        with pytest.raises(OSError):
            Image.open(p).load()
        with pytest.raises(IOError, match="at most 10"):
            jpeg.read_jpeg(str(p))
        return
    _assert_like_pil(str(p))


def _progressive(tmp_path) -> bytes:
    return open(_save(tmp_path / "p.jpg", _image(40, 56, 3, 3), quality=80, progressive=True), "rb").read()


def test_complete_progressive_files_never_need_smoothing(tmp_path):
    """PIL's progressive files deliver every coefficient, so libjpeg's block
    smoothing (jdcoefct.c) is off and the decode is exact; a file cut after
    its first scans would need the smoothing, and raises."""
    for q in QUALITIES:
        for sub in (0, 1, 2):
            for optimize in (False, True):
                _assert_like_pil(_save(tmp_path / "f.jpg", _image(33, 21, 3, q), quality=q, subsampling=sub,
                                       progressive=True, optimize=optimize))
    data = _progressive(tmp_path)
    sos = [i for i in range(len(data) - 1) if data[i] == 0xFF and data[i + 1] == 0xDA]
    cut = data[: sos[2]] + b"\xff\xd9"  # the DC scan and one AC scan, then EOI
    with pytest.raises(ValueError, match="smooth"):
        jpeg.decode_jpeg(cut)


def _patched(data: bytes, at: int, value: int) -> bytes:
    return data[:at] + bytes([value]) + data[at + 1 :]


def _sof_offset(data: bytes) -> int:
    return next(i for i in range(2, len(data) - 1) if data[i] == 0xFF and data[i + 1] in (0xC0, 0xC1, 0xC2))


@pytest.mark.parametrize("kind,error,match", [
    ("truncated", IOError, "truncated|premature"), ("garbage", IOError, "marker|Huffman|truncated"),
    ("bad_restart", IOError, "restart"),
    ("arithmetic", ValueError, "arithmetic"), ("12-bit", ValueError, "12-bit"),
    ("lossless", ValueError, "lossless"), ("cmyk", ValueError, "CMYK"), ("not_jpeg", ValueError, "neither"),
])
def test_jpeg_errors(tmp_path, kind, error, match):
    """Truncated and garbage streams raise IOError, as the JAX loader's
    tests ask of it (tests/test_native_loader.py); the forms the decoder
    does not read raise ValueError naming the form, from the port's reader
    and from decode_gray_batch."""
    p = str(tmp_path / "f.jpg")
    data = open(_save(tmp_path / "g.jpg", _image(64, 80, 1, 3), quality=95, restart_marker_blocks=2), "rb").read()
    sof = _sof_offset(data)
    if kind == "truncated":
        data = data[: len(data) // 3]
    elif kind == "garbage":
        data = data[:4] + b"\x00" * 256
    elif kind == "bad_restart":
        i = data.index(b"\xff\xd1")
        data = _patched(data, i + 1, 0xD3)
    elif kind == "arithmetic":
        data = _patched(data, sof + 1, 0xC9)
    elif kind == "12-bit":
        data = _patched(data, sof + 4, 12)
    elif kind == "lossless":
        data = _patched(data, sof + 1, 0xC3)
    elif kind == "cmyk":
        Image.fromarray(_image(16, 16, 3, 0)).convert("CMYK").save(p, "JPEG")
        data = open(p, "rb").read()
    else:
        data = b"GIF89a" + data[6:]
    open(p, "wb").write(data)
    if kind != "not_jpeg":
        with pytest.raises(error, match=match):
            jpeg.read_jpeg_gray(p)
    with pytest.raises(error, match=match):
        decode.read_image(p)
    with pytest.raises(error, match=match):
        tnl.decode_gray_batch([p], 64, 80)
    if kind in ("truncated", "garbage") and jnl.available():  # the JAX library fails them too
        with pytest.raises(IOError, match="failed"):
            jnl.decode_gray_batch([p], 64, 80)


def _manifest() -> list:
    with open(os.path.join(FIXTURES, "manifest.json")) as fh:
        return json.load(fh)["files"]


def _sha(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


@pytest.mark.parametrize("entry", _manifest(), ids=lambda e: e["file"])
def test_fixtures_match_their_manifest(entry):
    """The committed fixtures: the manifest's hashes are PIL's decode of the
    files (libpng's high byte for the 16-bit PNG), and the port's decode."""
    p = os.path.join(FIXTURES, entry["file"])
    with Image.open(p) as im:
        if im.mode == "I;16":
            own = gray = (np.asarray(im) >> 8).astype(np.uint8)
        else:
            own = np.asarray(im.convert("RGB" if im.mode in ("RGB", "P") else "L"))
            gray = np.asarray(im.convert("L"))
    assert _sha(own) == entry["sha256"] and _sha(gray) == entry["gray_sha256"]
    got = decode.read_image(p)
    assert list(got.shape) == entry["shape"] and _sha(got) == entry["sha256"]
    assert _sha(decode.read_image_gray(p)) == entry["gray_sha256"]
    assert decode.image_size(p) == tuple(entry["shape"][:2])
    assert sum(os.path.getsize(os.path.join(FIXTURES, e["file"])) for e in _manifest()) < 1 << 20


def _jax_pil(paths, h, w, monkeypatch):
    with monkeypatch.context() as m:
        m.setattr(jnl, "_load", lambda: None)
        return jnl.decode_gray_batch(paths, h, w, dtype=np.uint8)


@pytest.mark.parametrize("mode", ["L", "RGB", "RGB-unsaturated"])
def test_decode_gray_batch_jpeg_against_jax(tmp_path, monkeypatch, mode):
    """decode_gray_batch on a batch of JPEGs (baseline and progressive,
    every subsampling, restart intervals): equal to the JAX function's PIL
    path; against its libjpeg path (the Y plane, which PIL's ``draft("L")``
    also gives), equal on gray files and on every colour pixel whose
    R, G and B are unclipped; on an unsaturated colour image within 2
    levels everywhere."""
    h, w = 48, 72
    paths = []
    for k, (prog, sub) in enumerate([(False, 0), (False, 1), (False, 2), (True, 2), (True, 0)]):
        a = _image(h, w, 1 if mode == "L" else 3, seed=20 + k)
        if mode == "RGB-unsaturated":
            a = (40 + a.astype(np.uint16) * 175 // 255).astype(np.uint8)
        paths.append(_save(tmp_path / f"{k}.jpg", a, quality=85, progressive=prog, subsampling=sub,
                           restart_marker_blocks=k))
    got = tnl.decode_gray_batch(paths, h, w, threads=3, dtype=np.uint8)[..., 0]
    np.testing.assert_array_equal(got, _jax_pil(paths, h, w, monkeypatch)[..., 0])
    if not jnl.available():
        return
    native = jnl.decode_gray_batch(paths, h, w, threads=2, dtype=np.uint8)[..., 0]
    y_planes = []
    for p in paths:
        with Image.open(p) as im:
            im.draft("L", im.size)
            y_planes.append(np.asarray(im))
    np.testing.assert_array_equal(native, np.stack(y_planes))
    if mode == "L":
        np.testing.assert_array_equal(got, native)
        return
    rgb = np.stack([jpeg.read_jpeg(p, 3) for p in paths]).astype(np.int32)
    clipped = ((rgb == 0) | (rgb == 255)).any(axis=-1)
    differ = got != native
    assert not (differ & ~clipped).any()
    if mode == "RGB-unsaturated":
        assert np.abs(got.astype(np.int32) - native).max() <= 2
    else:
        assert differ.any()  # the noisy images clip, and there the two part
