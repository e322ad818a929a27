"""The port's PNG codec and threaded frame decoder against the JAX
package's ``decode_gray_batch`` and PIL, on the CPU.

Every PNG form is read (palette at 1/2/4/8 bits with and without tRNS,
gray at 1/2/4/8/16 bits, gray+alpha, RGB and RGBA at 8 and 16 bits, each
non-interlaced and Adam7), written here by a small writer, since PIL
cannot write Adam7 or 2-bit gray; each equals the JAX function's libpng
path (for colour, but where the two lumas round apart) and PIL, apart
from 16-bit gray, where PIL's ``convert("L")`` clips at 255 and the port
keeps libpng's high byte.

Every comparison is exact: decoding is integer work.  The compiled row
unfilter (``data/csrc/png_unfilter.cpp``) is held byte for byte to the
plain Python ``_unfilter``; ``decode_gray_batch`` to the JAX function for
gray, gray+alpha, RGB and RGBA files, every filter type, uint8 and
float32.  The JAX function takes its libpng library when that builds
(colour by a float64 luma) and PIL otherwise (PIL's fixed-point luma,
which the port follows): the port equals the PIL path everywhere, and
the library path everywhere but the colour pixels where the two lumas
round apart, which the test names.
"""

import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from iris_style_transfer_tpu.data import native_loader as jnl

from iris_style_transfer_tpu_torch.data import native_loader as tnl
from iris_style_transfer_tpu_torch.ops import cuda_build
from iris_style_transfer_tpu_torch.utils import png

H, W = 24, 40
MODES = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4}


def _jax_pil(paths, h, w, dtype, monkeypatch):
    with monkeypatch.context() as m:
        m.setattr(jnl, "_load", lambda: None)
        return jnl.decode_gray_batch(paths, h, w, dtype=dtype)


def _image(mode: str, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 256, (H, W, MODES[mode]), dtype=np.uint8)
    # smooth ramps too, so that the predictive filters meet real structure
    a[: H // 2] = (np.arange(W)[None, :, None] * 5 + np.arange(MODES[mode]) * 40).astype(np.uint8)
    return a


@pytest.mark.parametrize("bpp", [1, 2, 3, 4])
def test_compiled_unfilter_equals_python(bpp):
    rng = np.random.default_rng(bpp)
    h, stride = 37, 11 * bpp
    raw = rng.integers(0, 256, (h, stride + 1), dtype=np.uint8)
    raw[:, 0] = np.arange(h) % 5  # every filter type, each after each
    raw[0, 0] = 4  # Paeth on the first row, whose prior is zeros
    got = png.unfilter_rows(raw, bpp)
    prior, want = np.zeros(stride, np.uint8), []
    for r in range(h):
        prior = png._unfilter(int(raw[r, 0]), raw[r, 1:], prior, bpp)
        want.append(prior)
    np.testing.assert_array_equal(got, np.stack(want))


def test_unknown_filter_type_raises():
    raw = np.zeros((3, 9), np.uint8)
    raw[2, 0] = 5
    with pytest.raises(IOError, match="row 2 has filter type 5"):
        png.unfilter_rows(raw, 1)


@pytest.mark.parametrize("filter_type", png.FILTER_TYPES)
def test_writer_filters_read_back_by_pil_and_port(tmp_path, filter_type):
    for mode, ch in MODES.items():
        a = _image(mode, ch)
        p = str(tmp_path / f"{mode}.png")
        png.write_png(p, a, filter_type)
        with Image.open(p) as im:
            assert im.mode == mode
            np.testing.assert_array_equal(np.asarray(im).reshape(H, W, ch), a)
        np.testing.assert_array_equal(png.read_png(p), a)
        types = _filter_types(p)
        assert types == ({filter_type} if filter_type != "adaptive" else types) and types <= {0, 1, 2, 3, 4}


def _filter_types(path: str) -> set:
    """The row filter types of a file the port wrote (one IDAT chunk)."""
    raw = np.frombuffer(zlib.decompress(open(path, "rb").read()[41:-16]), np.uint8)
    return set(raw.reshape(H, -1)[:, 0].tolist())


def test_adaptive_filter_mixes_types(tmp_path):
    png.write_png(str(tmp_path / "a.png"), _image("L", 0), "adaptive")
    assert len(_filter_types(str(tmp_path / "a.png"))) >= 2


@pytest.mark.parametrize("mode", list(MODES))
def test_read_png_matches_pil_written_files(tmp_path, mode):
    a = _image(mode, 7)
    p = str(tmp_path / "pil.png")
    Image.fromarray(a[..., 0] if mode == "L" else a, mode).save(p)
    np.testing.assert_array_equal(png.read_png(p), a)
    with Image.open(p) as im:
        np.testing.assert_array_equal(png.read_png_gray(p), np.asarray(im.convert("L")))
    assert png.png_size(p) == (H, W)


def _files(tmp_path, mode):
    """Files of one mode: one written by PIL, one by the port per filter type."""
    paths = []
    for k, ft in enumerate(("pil",) + png.FILTER_TYPES):
        a = _image(mode, 10 + k)
        p = str(tmp_path / f"{mode}_{ft}.png")
        if ft == "pil":
            Image.fromarray(a[..., 0] if mode == "L" else a, mode).save(p)
        else:
            png.write_png(p, a, ft)
        paths.append(p)
    return paths


def _luma_disagree(paths) -> np.ndarray:
    """Where PIL's fixed-point luma and the float64 luma round apart."""
    rgb = np.stack([png.read_png(p)[..., :3] for p in paths]).astype(np.int64)
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    fixed = (r * 19595 + g * 38470 + b * 7471 + 0x8000) >> 16
    double = (0.299 * r + 0.587 * g + 0.114 * b + 0.5).astype(np.int64)
    return fixed != double


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("mode", list(MODES))
def test_decode_gray_batch_equals_jax(tmp_path, monkeypatch, mode, dtype):
    paths = _files(tmp_path, mode)
    got = tnl.decode_gray_batch(paths, H, W, threads=3, dtype=dtype)
    assert got.dtype == dtype and got.shape == (len(paths), H, W, 1)
    np.testing.assert_array_equal(got, _jax_pil(paths, H, W, dtype, monkeypatch))
    for i, p in enumerate(paths):
        with Image.open(p) as im:
            want = np.asarray(im.convert("L"))
        np.testing.assert_array_equal(got[i, ..., 0], want if dtype == np.uint8 else want.astype(np.float32) / 255)
    np.testing.assert_array_equal(got, tnl.decode_gray_batch(paths, H, W, threads=1, dtype=dtype))
    if jnl.available():
        native = jnl.decode_gray_batch(paths, H, W, threads=2, dtype=dtype)
        differ = native[..., 0] != got[..., 0]
        if MODES[mode] <= 2:
            assert not differ.any()
        else:  # the JAX library's float luma: only where the two lumas round apart, by one level
            np.testing.assert_array_equal(differ, _luma_disagree(paths))
            step = 1 if dtype == np.uint8 else 1 / 255
            assert np.abs(native.astype(np.float64) - got)[..., 0][differ].max(initial=0) <= step * 1.0001


def test_size_mismatch_raises_ioerror_in_both(tmp_path, monkeypatch):
    paths = _files(tmp_path, "L")[:2]
    with pytest.raises(IOError):
        tnl.decode_gray_batch(paths, H, W + 1)
    with pytest.raises(IOError):
        _jax_pil(paths, H, W + 1, np.uint8, monkeypatch)
    if jnl.available():
        with pytest.raises(IOError):
            jnl.decode_gray_batch(paths, H + 1, W)


_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
_SAMPLES = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # colour type -> samples per pixel


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)


def _pack(samples: np.ndarray, depth: int) -> np.ndarray:
    """(rows, n) integer samples -> (rows, stride) bytes: big-endian 16-bit,
    or 1/2/4-bit samples packed from the most significant bit."""
    n_rows, n = samples.shape
    if depth == 16:
        return samples.astype(">u2").view(np.uint8).reshape(n_rows, 2 * n)
    if depth == 8:
        return samples.astype(np.uint8)
    bits = ((samples[..., None] >> np.arange(depth - 1, -1, -1)) & 1).astype(np.uint8)
    return np.packbits(bits.reshape(n_rows, n * depth), axis=1)


def _write_png_form(path: str, samples: np.ndarray, depth: int, color: int, interlace: bool = False,
                    plte=None, trns: bytes | None = None) -> None:
    """A PNG of (H, W, samples) integers at any bit depth and colour type,
    non-interlaced or Adam7; row r of pass k takes filter (r + k) % 5."""
    h, w, ch = samples.shape
    bpp = max(1, ch * depth // 8)
    raw = []
    for k, (x0, y0, dx, dy) in enumerate(_ADAM7 if interlace else ((0, 0, 1, 1),)):
        sub = samples[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        rows = _pack(sub.reshape(sub.shape[0], -1), depth)
        for r, row in enumerate(rows):
            ft = (r + k) % 5
            x = row.astype(np.int32)
            up = rows[r - 1].astype(np.int32) if r else np.zeros_like(x)
            left = np.concatenate([np.zeros(bpp, np.int32), x[:-bpp]])
            upleft = np.concatenate([np.zeros(bpp, np.int32), up[:-bpp]])
            pred = [np.zeros_like(x), left, up, (left + up) >> 1,
                    png._paeth_np(left, up, upleft)][ft]
            raw.append(bytes([ft]) + ((x - pred) & 0xFF).astype(np.uint8).tobytes())
    out = _SIGNATURE + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, int(interlace)))
    if plte is not None:
        out += _png_chunk(b"PLTE", np.asarray(plte, np.uint8).tobytes())
    if trns is not None:
        out += _png_chunk(b"tRNS", trns)
    open(path, "wb").write(out + _png_chunk(b"IDAT", zlib.compress(b"".join(raw))) + _png_chunk(b"IEND", b""))


_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# (colour type, bit depth, tRNS or None)
PNG_FORMS = ([(3, d, None) for d in (1, 2, 4, 8)] + [(3, d, b"\x00\x80\x20") for d in (1, 2, 4, 8)]
             + [(0, d, None) for d in (1, 2, 4, 8, 16)] + [(0, 8, b"\x00\x05")]
             + [(c, d, None) for c in (2, 4, 6) for d in (8, 16)] + [(2, 8, b"\x00\x01\x00\x02\x00\x03")])


def _form_file(tmp_path, color: int, depth: int, trns, interlace: bool, seed: int = 0, hw=(H, W)) -> str:
    rng = np.random.default_rng(seed + depth + 10 * color)
    top = min(1 << depth, 7) if color == 3 else 1 << depth  # palette: 7 colours
    samples = rng.integers(0, top, (*hw, _SAMPLES[color]))
    samples[: hw[0] // 2] = np.arange(hw[1])[None, :, None] * 3 % top  # ramps, for the predictive filters
    plte = rng.integers(0, 256, (7, 3)) if color == 3 else None
    p = str(tmp_path / f"c{color}_d{depth}_t{trns is not None:d}_i{interlace:d}_{seed}.png")
    _write_png_form(p, samples, depth, color, interlace, plte, trns)
    return p


def _pil_gray(path: str) -> np.ndarray:
    with Image.open(path) as im:
        return np.asarray(im.convert("L"))


@pytest.mark.parametrize("interlace", [False, True], ids=["non-interlaced", "adam7"])
@pytest.mark.parametrize("color,depth,trns", PNG_FORMS,
                         ids=[f"type{c}-{d}bit{'-trns' if t else ''}" for c, d, t in PNG_FORMS])
def test_png_forms_read_as_jax_and_pil(tmp_path, monkeypatch, color, depth, trns, interlace):
    """read_png_gray and decode_gray_batch against the JAX function's libpng
    path (png_set_palette_to_rgb, expand_gray_1_2_4_to_8, strip_16,
    strip_alpha, interlace handling) and PIL; read_png's colours against
    PIL's convert("RGB")."""
    paths = [_form_file(tmp_path, color, depth, trns, interlace, seed) for seed in range(3)]
    got = tnl.decode_gray_batch(paths, H, W, threads=2, dtype=np.uint8)[..., 0]
    for i, p in enumerate(paths):
        np.testing.assert_array_equal(png.read_png_gray(p), got[i])
        with Image.open(p) as im:
            pil_rgb = np.asarray(im.convert("RGB"))
            pil_mode = im.mode
        own = png.read_png(p)
        assert own.shape[-1] == (3 if color == 3 else _SAMPLES[color])
        rgb = own[..., :3] if own.shape[-1] >= 3 else np.repeat(own[..., :1], 3, axis=-1)
        if pil_mode == "I;16":  # PIL clips; libpng and the port keep the high byte
            assert depth == 16 and color == 0
            raw = _png_16bit_samples(p)
            np.testing.assert_array_equal(got[i], raw >> 8)
            np.testing.assert_array_equal(_pil_gray(p), np.minimum(raw, 255))
        else:
            np.testing.assert_array_equal(rgb, pil_rgb)
            np.testing.assert_array_equal(got[i], _pil_gray(p))
    if color != 0 or depth != 16:
        np.testing.assert_array_equal(got, _jax_pil(paths, H, W, np.uint8, monkeypatch)[..., 0])
    if jnl.available():
        native = jnl.decode_gray_batch(paths, H, W, threads=2, dtype=np.uint8)[..., 0]
        differ = native != got
        if color in (0, 4):
            assert not differ.any()
        else:  # colour: the JAX library's float luma parts from PIL's where the two round apart
            rgb = np.stack([png.read_png(p)[..., :3] for p in paths]).astype(np.int64)
            np.testing.assert_array_equal(differ, _luma_disagree_rgb(rgb))


def _png_16bit_samples(path: str) -> np.ndarray:
    """The 16-bit gray samples as written, by PIL's own I;16 read."""
    with Image.open(path) as im:
        return np.asarray(im).astype(np.int64)


def _luma_disagree_rgb(rgb: np.ndarray) -> np.ndarray:
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    fixed = (r * 19595 + g * 38470 + b * 7471 + 0x8000) >> 16
    return fixed != (0.299 * r + 0.587 * g + 0.114 * b + 0.5).astype(np.int64)


def test_pil_clips_16bit_gray_and_the_port_keeps_the_high_byte(tmp_path, monkeypatch):
    """PIL opens a 16-bit gray PNG as I;16, and convert("L") clips it at 255:
    256, 1000 and 65535 all come out 255, so every real 16-bit frame would
    read white.  The port keeps the high byte, as libpng's strip_16 and the
    JAX function's libpng path do."""
    values = np.array([[0, 255, 256, 1000], [4095, 32768, 65280, 65535]], np.uint16)
    p = str(tmp_path / "g16.png")
    Image.fromarray(values).save(p)
    with Image.open(p) as im:
        assert im.mode == "I;16"
        np.testing.assert_array_equal(np.asarray(im.convert("L")), [[0, 255, 255, 255], [255, 255, 255, 255]])
    want = (values >> 8).astype(np.uint8)  # [[0, 0, 1, 3], [15, 128, 255, 255]]
    np.testing.assert_array_equal(png.read_png_gray(p), want)
    np.testing.assert_array_equal(tnl.decode_gray_batch([p], 2, 4, dtype=np.uint8)[0, ..., 0], want)
    np.testing.assert_array_equal(_jax_pil([p], 2, 4, np.uint8, monkeypatch)[0, ..., 0], 255 * (values > 0))
    if jnl.available():
        np.testing.assert_array_equal(jnl.decode_gray_batch([p], 2, 4, dtype=np.uint8)[0, ..., 0], want)


def _interlaced(path: str) -> None:
    """An 8-bit gray Adam7 PNG of _image("L", 0)."""
    _write_png_form(path, _image("L", 0).astype(np.int64), 8, 0, interlace=True)


@pytest.mark.parametrize("kind,match", [
    pytest.param("palette", None, id="palette-palette"),
    pytest.param("16-bit", None, id="16-bit-bit depth 16"),
    pytest.param("interlaced", None, id="interlaced-interlace 1"),
    pytest.param("jpeg", None, id="jpeg-JPEG"),
    pytest.param("gif", "neither a PNG nor a JPEG", id="gif"),
    pytest.param("cmyk", "CMYK", id="cmyk-jpeg"),
    pytest.param("arithmetic", "arithmetic", id="arithmetic-jpeg"),
    pytest.param("bad-ihdr", "bad IHDR", id="bad-ihdr"),
])
def test_unsupported_files_raise(tmp_path, monkeypatch, kind, match):
    """The forms the JAX package reads (palette, 16-bit, Adam7, JPEG) read
    as its PIL path gives them (libpng's high byte for 16-bit gray); what no
    JAX path reads raises: another format and the JPEG forms the decoder
    refuses as ValueError, a PNG header no decoder reads as IOError."""
    p = str(tmp_path / "f.png")
    if kind == "palette":
        Image.fromarray(_image("RGB", 0)).convert("P").save(p)
    elif kind == "16-bit":
        Image.fromarray((_image("L", 0)[..., 0].astype(np.uint16) * 257)).save(p)
    elif kind == "interlaced":
        _interlaced(p)
    elif kind in ("jpeg", "arithmetic"):
        Image.fromarray(_image("L", 0)[..., 0]).save(p, format="JPEG")
        if kind == "arithmetic":  # SOF0 -> SOF9
            data = open(p, "rb").read()
            open(p, "wb").write(data.replace(b"\xff\xc0", b"\xff\xc9", 1))
    elif kind == "cmyk":
        Image.fromarray(_image("RGB", 0)).convert("CMYK").save(p, format="JPEG")
    elif kind == "gif":
        Image.fromarray(_image("RGB", 0)).save(p, format="GIF")
    else:
        png.write_png(p, _image("L", 0))
        data = bytearray(open(p, "rb").read())
        data[24] = 3  # IHDR's bit depth: 3 bits is no PNG form
        open(p, "wb").write(bytes(data))
    if match is not None:
        with pytest.raises(IOError if kind == "bad-ihdr" else ValueError, match=match):
            tnl.decode_gray_batch([p], H, W)
        return
    got = tnl.decode_gray_batch([p], H, W, dtype=np.uint8)
    if kind == "16-bit":
        np.testing.assert_array_equal(got[0, ..., 0], _image("L", 0)[..., 0])  # (v * 257) >> 8 == v
    else:
        np.testing.assert_array_equal(got, _jax_pil([p], H, W, np.uint8, monkeypatch))
    if jnl.available() and kind != "palette":
        np.testing.assert_array_equal(got, jnl.decode_gray_batch([p], H, W, dtype=np.uint8))


def test_corrupt_stream_raises_ioerror(tmp_path):
    p = str(tmp_path / "c.png")
    png.write_png(p, _image("L", 1))
    data = open(p, "rb").read()
    open(p, "wb").write(data[:60] + bytes(40) + data[100:])
    with pytest.raises(IOError):
        tnl.decode_gray_batch([p], H, W)


def test_failed_helper_build_raises_and_nothing_falls_back(tmp_path, monkeypatch):
    src = tmp_path / "broken.cpp"
    src.write_text("extern \"C\" int f( {\n")
    with pytest.raises(RuntimeError, match="failed to build"):
        cuda_build.load_host_library(str(src))
    p = str(tmp_path / "ok.png")
    png.write_png(p, _image("L", 2))

    def refuse(path):
        raise RuntimeError("build refused")

    monkeypatch.setattr(cuda_build, "load_host_library", refuse)
    monkeypatch.setattr(png, "_LIB", None)
    with pytest.raises(RuntimeError, match="build refused"):
        png.read_png(p)
    with pytest.raises(RuntimeError, match="build refused"):
        tnl.decode_gray_batch([p], H, W)
