"""Classic Gatys NST demo: style-transfer a content/style image pair.

Counterpart of the JAX package's ``demo/nst_demo.py``, with its flags plus
``--device`` (default ``cuda``):

    python -m iris_style_transfer_tpu_torch.demos.nst_demo --gram --device cuda \
        [--content c.png --style s.png] --size 256 --epochs 200 --out nst_out.png

Without --content/--style it makes the JAX demo's procedural image pair
from numpy.  User images are PNGs, read with ``utils/png.py`` (no imaging
library is needed) and resized with an antialiased bilinear filter.
``--gram`` runs the Gram style loss, whose Gram matrices go through the
hand-written kernel on a CUDA device (``ops/blockwise_gram.py``); the
default is the BN-statistics loss.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch
import torch.nn.functional as F

from ..models import VGG19, load_pretrained
from ..runtime.config import resolve_device
from ..transfer.nst import NSTResult, nst
from ..utils.png import read_png, write_png


def procedural_image(size: int, seed: int) -> np.ndarray:
    """The JAX demo's self-contained (size, size, 3) float32 image."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    base = np.stack([np.sin(6 * yy + seed), np.cos(5 * xx - seed), np.sin(4 * (xx + yy))], axis=-1)
    return np.clip(0.5 + 0.35 * base + rng.normal(0, 0.05, (size, size, 3)), 0, 1).astype(np.float32)


def load_image(path: str, size: int, seed: int, device: torch.device) -> torch.Tensor:
    """(1, 3, size, size) float32 in [0,1]: a PNG resized, or the
    procedural image."""
    if not path:
        return torch.from_numpy(procedural_image(size, seed)).permute(2, 0, 1)[None].to(device)
    a = read_png(path)
    rgb = np.repeat(a[..., :1], 3, axis=-1) if a.shape[-1] <= 2 else a[..., :3]  # drop alpha
    x = torch.from_numpy(rgb.astype(np.float32) / 255.0).permute(2, 0, 1)[None].to(device)
    return F.interpolate(x, size=(size, size), mode="bilinear", antialias=True, align_corners=False)


def main(argv: list[str] | None = None) -> NSTResult:
    p = argparse.ArgumentParser()
    p.add_argument("--content", type=str, default="")
    p.add_argument("--style", type=str, default="")
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--epochs", type=int, default=200)
    p.add_argument("--cw", type=float, default=1.0)
    p.add_argument("--sw", type=float, default=1.0)
    p.add_argument("--optimizer", type=str, default="lbfgs", choices=["lbfgs", "adam"])
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--gram", action="store_true", help="Gram style loss instead of BN")
    p.add_argument("--out", type=str, default="nst_out.png")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on; a CUDA request without CUDA fails")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    c = load_image(args.content, args.size, 1, device)
    s = load_image(args.style, args.size, 2, device)
    # ported torchvision weights when present, seeded He init otherwise
    params = load_pretrained("vgg19", init_fn=lambda: VGG19.init(torch.Generator().manual_seed(0), device),
                             device=device)

    lr = args.lr if args.lr is not None else (1.0 if args.optimizer == "lbfgs" else 0.02)
    t0 = time.perf_counter()
    res = nst(c, s, params, BN_loss=not args.gram, c_loss_weight=args.cw, s_loss_weight=args.sw,
              epochs=args.epochs, optimizer=args.optimizer, lr=lr)
    out = res.x[0].permute(1, 2, 0).cpu().numpy()  # waits for the device
    dt = time.perf_counter() - t0
    print(f"{args.epochs} steps in {dt:.2f}s ({args.epochs / dt:.1f} steps/s) on {device}")
    print(f"c_loss {float(res.c_loss_hist[-1]):.5g}  s_loss {float(res.s_loss_hist[-1]):.5g}")
    write_png(args.out, out)
    print("wrote", args.out)
    return res


if __name__ == "__main__":
    main()
