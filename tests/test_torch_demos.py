"""The port's demos at a tiny size on the CPU, and the stdlib PNG codec and
the demo's image resize against PIL (which the port itself never imports).

Tolerances: the codec is exact both ways, for every colour type it writes
and every filter type it reads; the antialiased bilinear resize is within
1.5/255 of PIL's (PIL rounds to 8 bits, with fixed-point weights).
"""

import os
import struct
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from iris_style_transfer_tpu_torch.demos import iris_nst_demo, nst_demo
from iris_style_transfer_tpu_torch.data import synthetic as tsyn
from iris_style_transfer_tpu_torch.utils.png import read_png, write_png

_MODES = {1: "L", 2: "LA", 3: "RGB", 4: "RGBA"}


def _image(h, w, ch, seed):
    return np.random.default_rng(seed).integers(0, 256, (h, w, ch), dtype=np.uint8)


@pytest.mark.parametrize("ch", [1, 2, 3, 4])
def test_png_round_trips_through_pil(tmp_path, ch):
    a = _image(13, 17, ch, ch)
    write_png(str(tmp_path / "ours.png"), a)
    got = np.asarray(Image.open(tmp_path / "ours.png"))
    np.testing.assert_array_equal(got.reshape(a.shape), a)
    Image.fromarray(a[..., 0] if ch == 1 else a, _MODES[ch]).save(tmp_path / "pil.png", optimize=True)
    np.testing.assert_array_equal(read_png(str(tmp_path / "pil.png")), a)


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _filtered_png(a: np.ndarray, color_type: int) -> bytes:
    """A PNG whose row r uses filter type r % 5 (PNG spec section 9)."""
    h, w, bpp = a.shape
    rows = a.reshape(h, w * bpp).astype(int)
    out = b""
    for r in range(h):
        f, line = r % 5, []
        for i in range(w * bpp):
            x = rows[r, i]
            left = rows[r, i - bpp] if i >= bpp else 0
            up = rows[r - 1, i] if r else 0
            ul = rows[r - 1, i - bpp] if r and i >= bpp else 0
            pred = [0, left, up, (left + up) // 2, _paeth(left, up, ul)][f]
            line.append((x - pred) % 256)
        out += bytes([f] + line)

    def chunk(tag, data):
        return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(out)) + chunk(b"IEND", b""))


@pytest.mark.parametrize("ch,color_type", [(1, 0), (3, 2), (4, 6)])
def test_png_reads_all_five_filter_types(tmp_path, ch, color_type):
    a = _image(11, 9, ch, 7)
    path = tmp_path / "f.png"
    path.write_bytes(_filtered_png(a, color_type))
    np.testing.assert_array_equal(np.asarray(Image.open(path)).reshape(a.shape), a)  # the file is valid
    np.testing.assert_array_equal(read_png(str(path)), a)


def test_png_refuses_what_it_does_not_read(tmp_path):
    Image.fromarray(_image(4, 4, 3, 1)).convert("P").save(tmp_path / "p.png")
    with pytest.raises(ValueError, match="colour type 3"):
        read_png(str(tmp_path / "p.png"))
    (tmp_path / "x.png").write_bytes(b"GIF89a")
    with pytest.raises(ValueError, match="not a PNG"):
        read_png(str(tmp_path / "x.png"))


@pytest.mark.parametrize("src_hw,size", [((64, 48), 32), ((20, 28), 40)])
def test_demo_resize_matches_pil_bilinear(tmp_path, src_hw, size):
    a = _image(*src_hw, 3, 3)
    write_png(str(tmp_path / "c.png"), a)
    got = nst_demo.load_image(str(tmp_path / "c.png"), size, 0, torch.device("cpu"))
    want = np.asarray(Image.fromarray(a).resize((size, size), Image.BILINEAR), np.float32) / 255.0
    assert got.shape == (1, 3, size, size)
    np.testing.assert_allclose(got[0].permute(1, 2, 0).numpy(), want, atol=1.5 / 255)


@pytest.mark.parametrize("gram", [True, False])
def test_nst_demo_runs_on_cpu(tmp_path, gram):
    out = tmp_path / "nst.png"
    res = nst_demo.main(["--size", "32", "--epochs", "3", "--device", "cpu", "--out", str(out)]
                        + (["--gram"] if gram else []))
    assert res.x.shape == (1, 3, 32, 32) and torch.isfinite(res.s_loss_hist).all()
    assert read_png(str(out)).shape == (32, 32, 3)
    # the same procedural pair as the JAX demo, made from numpy
    np.testing.assert_array_equal(nst_demo.load_image("", 8, 1, torch.device("cpu"))[0].permute(1, 2, 0).numpy(),
                                  nst_demo.procedural_image(8, 1))


def test_iris_nst_demo_runs_on_cpu(tmp_path, monkeypatch, capsys):
    """Synthetic eyes at 48x64 and 32x32 crops; then the reference pair
    discovered in --reference_dir, one of odd extent (padded to /16)."""
    monkeypatch.setattr(iris_nst_demo, "CROP", (32, 32))
    monkeypatch.setattr(iris_nst_demo, "synthetic_eye_batch", lambda n, height, width, seed:
                        tsyn.synthetic_eye_batch(n, 48, 64, seed=seed))
    outdir = tmp_path / "out"
    res = iris_nst_demo.main(["--epochs", "2", "--outdir", str(outdir), "--device", "cpu",
                              "--reference_dir", str(tmp_path / "none")])
    names = ("content_eye.png", "style_eye.png", "content_iris.png", "style_iris.png",
             "stylized_iris.png", "result_eye.png")
    assert sorted(os.listdir(outdir)) == sorted(names)
    assert read_png(str(outdir / "result_eye.png")).shape == (48, 64, 1)
    assert res.x.shape == (1, 3, 32, 32) and res.x_hist.shape[0] == 2 and torch.isfinite(res.s_loss_hist).all()

    ref = tmp_path / "ref"
    ref.mkdir()
    eyes = tsyn.synthetic_eye_batch(2, 48, 64, seed=3)[0]
    write_png(str(ref / iris_nst_demo.CONTENT_NAME), np.repeat(eyes[0][:45, :60], 3, axis=-1))
    write_png(str(ref / iris_nst_demo.STYLE_NAME), eyes[1])
    iris_nst_demo.main(["--epochs", "1", "--outdir", str(outdir), "--device", "cpu", "--reference_dir", str(ref)])
    printed = capsys.readouterr().out
    assert "using reference eye crops" in printed and "padding (45, 60) by (3, 4)" in printed
    assert read_png(str(outdir / "result_eye.png")).shape == (48, 64, 1)
