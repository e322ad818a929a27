"""The port's demos at a tiny size on the CPU, the stdlib PNG codec and the
demo's image loading against PIL (which the port itself never imports),
and ``plot_help`` against the JAX package's.

Tolerances: none.  The codec is exact both ways, for every colour type it
writes and every filter type it reads; the NST demo's ``load_image`` (a
PNG or JPEG read as RGB, then PIL's fixed-point bilinear resample ported
to numpy) equals the JAX demo's, which PIL runs, bit for bit.
"""

import importlib.util
import os
import struct
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from iris_style_transfer_tpu.utils import misc as jmisc

from iris_style_transfer_tpu_torch.demos import iris_nst_demo, nst_demo
from iris_style_transfer_tpu_torch.data import synthetic as tsyn
from iris_style_transfer_tpu_torch.utils import misc as tmisc
from iris_style_transfer_tpu_torch.utils.png import read_png, write_png

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

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
    """A palette PNG now reads, as PIL's convert("RGB"); a file that is not
    a PNG still raises."""
    Image.fromarray(_image(4, 4, 3, 1)).convert("P").save(tmp_path / "p.png")
    with Image.open(tmp_path / "p.png") as im:
        np.testing.assert_array_equal(read_png(str(tmp_path / "p.png")), np.asarray(im.convert("RGB")))
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
    np.testing.assert_array_equal(got[0].permute(1, 2, 0).numpy(), want)


@pytest.mark.parametrize("out_hw", [(1, 1), (5, 7), (32, 32), (128, 300)])
@pytest.mark.parametrize("in_hw", [(1, 1), (7, 9), (33, 17), (3, 400)])
def test_resize_bilinear_equals_pil(in_hw, out_hw):
    """PIL's two-pass fixed-point resample, shrinking and enlarging, both
    passes and one (an axis whose extent stays is not resampled)."""
    a = _image(*in_hw, 3, in_hw[0] + out_hw[1])
    want = np.asarray(Image.fromarray(a).resize((out_hw[1], out_hw[0]), Image.BILINEAR))
    np.testing.assert_array_equal(nst_demo.resize_bilinear(a, out_hw), want)
    np.testing.assert_array_equal(nst_demo.resize_bilinear(a, (in_hw[0], out_hw[1])),
                                  np.asarray(Image.fromarray(a).resize((out_hw[1], in_hw[0]), Image.BILINEAR)))


def _jax_demo():
    """The JAX package's demo/nst_demo.py, loaded by path (it imports jax
    only inside main)."""
    spec = importlib.util.spec_from_file_location("jax_nst_demo", os.path.join(REPO, "demo", "nst_demo.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("kind", ["png-rgb", "png-rgba", "png-gray", "png-palette", "jpeg-420", "jpeg-progressive",
                                  "jpeg-gray"])
def test_demo_load_image_equals_jax_demo(tmp_path, kind):
    """nst_demo.load_image on PNG and JPEG files against the JAX demo's
    load_image (PIL's convert("RGB") + resize(BILINEAR), / 255), at 0
    tolerance, shrinking to 32 and enlarging to 96."""
    a = _image(45, 61, 3, 11)
    a[:20] = np.linspace(0, 255, 61, dtype=np.uint8)[None, :, None]  # smooth, for the JPEG's chroma
    p = str(tmp_path / ("f.jpg" if kind.startswith("jpeg") else "f.png"))
    if kind == "png-rgb":
        write_png(p, a)
    elif kind == "png-rgba":
        write_png(p, np.concatenate([a, a[..., :1]], axis=-1))
    elif kind == "png-gray":
        write_png(p, a[..., :1])
    elif kind == "png-palette":
        Image.fromarray(a).quantize(32).save(p)
    elif kind == "jpeg-gray":
        Image.fromarray(a[..., 0]).save(p, quality=90)
    else:
        Image.fromarray(a).save(p, quality=90, subsampling=2, progressive=kind == "jpeg-progressive")
    jdemo = _jax_demo()
    for size in (32, 96):
        got = nst_demo.load_image(p, size, 0, torch.device("cpu"))[0].permute(1, 2, 0).numpy()
        want = jdemo.load_image(p, size, 0)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


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


@pytest.mark.parametrize("kind", ["gray", "colour-progressive"])
def test_iris_demo_reads_jpeg_eyes(tmp_path, kind):
    """load_eye on a JPEG: PIL's convert("L") / 255, as the JAX demo's
    loader, reflect-padded to /16."""
    eye = np.round(tsyn.synthetic_eye_batch(1, 45, 60, seed=4)[0][0] * 255).astype(np.uint8)
    p = str(tmp_path / "eye.jpg")
    if kind == "gray":
        Image.fromarray(eye[..., 0]).save(p, quality=90)
    else:
        Image.fromarray(np.repeat(eye, 3, axis=-1) // np.array([1, 2, 3], np.uint8)).save(p, progressive=True)
    with Image.open(p) as im:
        want = np.asarray(im.convert("L"), np.float32)[..., None] / 255.0
    got = iris_nst_demo.load_eye(p, 0)
    assert got.shape == (48, 64, 1)
    np.testing.assert_array_equal(got[:45, :60], want)


def _axes_state(fig) -> list:
    """Each axes' title, axis visibility and image (array, colour map)."""
    out = []
    for ax in fig.axes:
        ims = ax.get_images()
        out.append((ax.get_title(), ax.axison, [(np.asarray(im.get_array()), im.get_cmap().name) for im in ims]))
    return out


@pytest.mark.parametrize("grayscale,axis_off,n", [(True, False, 3), (False, True, 1)])
def test_plot_help_draws_as_jax(monkeypatch, grayscale, axis_off, n):
    """plot_help under matplotlib's Agg backend, plt.show patched out: the
    same figure size, titles, axes and images as the JAX package's, from
    numpy arrays and from tensors."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    monkeypatch.setattr(plt, "show", lambda: None)
    rng = np.random.default_rng(n)
    images = [rng.random((6, 8, 1), np.float32), rng.random((6, 8), np.float32),
              rng.random((6, 8, 3), np.float32)][:n]
    titles = [f"t{i}" for i in range(n)]
    states = []
    for fn, imgs in ((jmisc.plot_help, images), (tmisc.plot_help, images),
                     (tmisc.plot_help, [torch.from_numpy(a) for a in images])):
        plt.close("all")
        fn(imgs, titles, grayscale=grayscale, axis_off=axis_off)
        fig = plt.gcf()
        states.append((tuple(fig.get_size_inches()), _axes_state(fig)))
    plt.close("all")
    assert states[0][0] == states[1][0] == states[2][0] == (n * 3 + 1, 3)
    for got in states[1:]:
        for (t0, on0, ims0), (t1, on1, ims1) in zip(states[0][1], got[1], strict=True):
            assert (t0, on0) == (t1, on1) and len(ims0) == len(ims1) == 1
            np.testing.assert_array_equal(ims0[0][0], ims1[0][0])
            assert ims0[0][1] == ims1[0][1]
