"""Single-image iris style transfer demo.

Counterpart of the JAX package's ``demo/iris_nst_demo.py`` (the reference's
``iris_style_transfer.ipynb``), with its flags plus ``--device`` (default
``cuda``) and ``--reference_dir``:

    python -m iris_style_transfer_tpu_torch.demos.iris_nst_demo --device cuda \
        [--content eye1.png --style eye2.png] --epochs 200 --outdir saved/iris_demo

Two eye images -> RITnet mask and crop of both irises -> NST with
``c_loss_weight=0, s_loss_weight=1`` -> the stylized iris composited back
into the content eye.  Writes before/after PNGs with ``utils/png.py``.

Without image arguments it runs on synthetic eyes.  ``--reference_dir``
names a folder holding the reference's real eye crops
(``000000339816.png`` content, ``000000240703.png`` style: the pair the
notebook composites); it is empty by default, so the demo reads nothing
outside the paths it is given.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..data import synthetic_eye_batch
from ..models import RITnet, VGG19, load_pretrained
from ..pipelines import composite_batch, mask_and_crop_iris
from ..runtime.config import resolve_device
from ..transfer.nst import NSTResult, nst
from ..utils.png import read_png, write_png

CROP = (224, 224)  # the NST's iris crop
CONTENT_NAME, STYLE_NAME = "000000339816.png", "000000240703.png"


def load_eye(path: str, seed: int) -> np.ndarray:
    """(H, W, 1) float32 eye in [0,1]: a PNG as luma, reflect-padded to
    extents divisible by 16 (RITnet's four pools), or a synthetic eye."""
    if not path:
        return synthetic_eye_batch(1, height=400, width=640, seed=seed)[0][0]
    a = read_png(path).astype(np.uint32)
    if a.shape[-1] >= 3:  # ITU-R 601-2 luma, in the integer form imaging libraries use
        a = (a[..., 0] * 19595 + a[..., 1] * 38470 + a[..., 2] * 7471 + 0x8000) >> 16
    else:
        a = a[..., 0]
    arr = a.astype(np.float32)[..., None] / 255.0
    ph, pw = (-arr.shape[0]) % 16, (-arr.shape[1]) % 16
    if ph or pw:
        print(f"padding {arr.shape[:2]} by ({ph}, {pw}) to /16-divisible")
        arr = np.pad(arr, ((0, ph), (0, pw), (0, 0)), mode="reflect")
    return arr


def main(argv: list[str] | None = None) -> NSTResult:
    p = argparse.ArgumentParser()
    p.add_argument("--content", type=str, default="")
    p.add_argument("--style", type=str, default="")
    p.add_argument("--epochs", type=int, default=200)
    p.add_argument("--outdir", type=str, default="saved/iris_demo")
    p.add_argument("--reference_dir", type=str, default="",
                   help="folder holding the reference's eye crops; empty: synthetic eyes")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on; a CUDA request without CUDA fails")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    os.makedirs(args.outdir, exist_ok=True)
    # the notebook's real eye-crop pair, when a folder is given; a user
    # --style is never replaced
    ref_content = os.path.join(args.reference_dir, CONTENT_NAME)
    if args.reference_dir and not args.content and os.path.exists(ref_content):
        args.content = ref_content
        if not args.style:
            args.style = os.path.join(args.reference_dir, STYLE_NAME)
        print(f"using reference eye crops from {args.reference_dir}")

    c_eye = torch.from_numpy(load_eye(args.content, 1))[None].to(device)
    s_eye = torch.from_numpy(load_eye(args.style, 2))[None].to(device)
    ritnet = RITnet.pretrained(device)
    vgg = load_pretrained("vgg19", init_fn=lambda: VGG19.init(torch.Generator().manual_seed(0), device),
                          device=device)

    c_iris, c_mask, c_bbox = mask_and_crop_iris(c_eye, ritnet, out_size=CROP)
    s_iris, _, _ = mask_and_crop_iris(s_eye, ritnet, out_size=CROP)
    # style-only NST, as the notebook (c_loss_weight=0, s_loss_weight=1)
    res = nst(c_iris.permute(0, 3, 1, 2), s_iris.permute(0, 3, 1, 2), vgg, c_loss_weight=0.0,
              s_loss_weight=1.0, epochs=args.epochs, history_every=max(args.epochs // 10, 1))
    new_eye = composite_batch(c_eye, res.x.permute(0, 2, 3, 1), c_mask, c_bbox)

    for name, img in (("content_eye.png", c_eye[0]), ("style_eye.png", s_eye[0]),
                      ("content_iris.png", c_iris[0]), ("style_iris.png", s_iris[0]),
                      ("stylized_iris.png", res.x[0].permute(1, 2, 0)), ("result_eye.png", new_eye[0])):
        write_png(os.path.join(args.outdir, name), img.cpu().numpy())
    print(f"s_loss {float(res.s_loss_hist[0]):.5g} -> {float(res.s_loss_hist[-1]):.5g}")
    print("wrote PNGs to", args.outdir)
    return res


if __name__ == "__main__":
    main()
