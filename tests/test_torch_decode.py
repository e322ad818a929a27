"""The port's PNG codec and threaded frame decoder against the JAX
package's ``decode_gray_batch`` and PIL, on the CPU.

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


def _interlaced(path: str) -> None:
    png.write_png(path, _image("L", 0))
    data = bytearray(open(path, "rb").read())
    data[28] = 1  # IHDR's interlace byte
    data[29:33] = struct.pack(">I", zlib.crc32(bytes(data[12:29])) & 0xFFFFFFFF)
    open(path, "wb").write(bytes(data))


@pytest.mark.parametrize("kind,match", [("palette", "palette"), ("16-bit", "bit depth 16"),
                                        ("interlaced", "interlace 1"), ("jpeg", "JPEG")])
def test_unsupported_files_raise(tmp_path, kind, match):
    p = str(tmp_path / "f.png")
    if kind == "palette":
        Image.fromarray(_image("RGB", 0)).convert("P").save(p)
    elif kind == "16-bit":
        Image.fromarray((_image("L", 0)[..., 0].astype(np.uint16) * 257)).save(p)
    elif kind == "interlaced":
        _interlaced(p)
    else:
        Image.fromarray(_image("L", 0)[..., 0]).save(p, format="JPEG")
    with pytest.raises(ValueError, match=match):
        tnl.decode_gray_batch([p], H, W)


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
