"""RITnet (DenseNet2D, Chaudhary et al. 2019) for 4-class eye segmentation,
with its preprocessing, in plain float32 PyTorch.

Preprocessing: the 256-level gamma 0.8 table, OpenCV's CLAHE (clip 1.5,
8x8 tiles), normalize (0.5, 0.5).  Network: five dense down blocks (2x2
average pool between them), four dense up blocks (nearest x2 upsample,
skip concat), LeakyReLU(0.01), eval batchnorm at each down block's
output, a 1x1 output conv.  Weights come from the bundled ``ritnet.npz``
(JAX layout: HWIO convs, '/'-joined keys), read here as a file.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .precision import F32, Precision


def load_ritnet(path: str, device) -> dict:
    """The npz as nested dicts of OIHW float32 tensors on ``device``."""
    tree: dict = {}
    with np.load(path) as z:
        for key in z.files:
            *outer, leaf = key.split("/")
            node = tree
            for k in outer:
                node = node.setdefault(k, {})
            a = z[key]
            if leaf == "w" and a.ndim == 4:
                a = np.transpose(a, (3, 2, 0, 1))
            node[leaf] = torch.from_numpy(np.ascontiguousarray(a)).float().to(device)
    return tree


def gamma_table(gamma: float = 0.8) -> np.ndarray:
    return (255.0 * np.linspace(0.0, 1.0, 256) ** gamma).astype(np.uint8).astype(np.float32)


def clahe_u8(levels: torch.Tensor, clip: float = 1.5, grid=(8, 8)) -> torch.Tensor:
    """OpenCV's CLAHE of (B, H, W) integer levels -> float levels 0..255."""
    b, h, w = levels.shape
    gh, gw = grid
    th, tw = h // gh, w // gw
    area = th * tw
    lv = levels.long()
    tiles = lv.reshape(b, gh, th, gw, tw).permute(0, 1, 3, 2, 4).reshape(b, gh * gw, area)
    hist = torch.zeros(b, gh * gw, 256, device=lv.device)
    hist.scatter_add_(2, tiles, torch.ones_like(tiles, dtype=torch.float32))
    limit = float(max(int(clip * area / 256.0), 1))
    excess = torch.clamp_min(hist - limit, 0.0).sum(-1, keepdim=True)
    hist = torch.clamp_max(hist, limit)
    per_bin = torch.floor(excess / 256.0)
    rest = excess - per_bin * 256.0
    hist = hist + per_bin
    step = torch.clamp_min(torch.floor(256.0 / torch.clamp_min(rest, 1.0)), 1.0)
    i = torch.arange(256, device=lv.device, dtype=torch.float32)
    bump = (torch.remainder(i, step) == 0) & (torch.floor(i / step) < rest)
    hist = hist + bump.float()
    lut = torch.clamp(torch.round(torch.cumsum(hist, -1) * (255.0 / area)), 0.0, 255.0)
    ty = torch.arange(h, device=lv.device, dtype=torch.float32) / th - 0.5
    tx = torch.arange(w, device=lv.device, dtype=torch.float32) / tw - 0.5
    y0, x0 = torch.floor(ty), torch.floor(tx)
    wy, wx = (ty - y0)[:, None], (tx - x0)[None, :]
    y0i, x0i = y0.long(), x0.long()
    ys = (y0i.clamp(0, gh - 1), (y0i + 1).clamp(0, gh - 1))
    xs = (x0i.clamp(0, gw - 1), (x0i + 1).clamp(0, gw - 1))

    def at(yi, xi):
        tile = (yi[:, None] * gw + xi[None, :]).expand(b, h, w)
        return torch.gather(lut.reshape(b, -1), 1, (tile * 256 + lv).reshape(b, -1)).reshape(b, h, w)

    top = at(ys[0], xs[0]) * (1 - wx) + at(ys[0], xs[1]) * wx
    bot = at(ys[1], xs[0]) * (1 - wx) + at(ys[1], xs[1]) * wx
    return torch.clamp(torch.round(top * (1 - wy) + bot * wy), 0.0, 255.0)


def preprocess(frames: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 1) frames in [0, 1] -> (B, 1, H, W) network input."""
    lv = torch.round(frames[..., 0].float().clamp(0, 1) * 255.0).long()
    g = torch.from_numpy(gamma_table()).to(frames.device)[lv]
    y = clahe_u8(torch.round(g).long()) / 255.0
    return ((y - 0.5) / 0.5)[:, None]


def _conv(p, x, prec: Precision, pad: int = 0):
    return F.conv2d(prec.q("tf32", x), prec.q("tf32", p["w"]), p["b"], padding=pad)


def _bn(p, x, eps: float = 1e-5):
    v = lambda k: p[k].view(1, -1, 1, 1)  # noqa: E731
    return (x - v("mean")) / torch.sqrt(v("var") + eps) * v("scale") + v("bias")


def _down(p, x, down: bool, prec):
    act = lambda t: F.leaky_relu(t, 0.01)  # noqa: E731
    if down:
        x = F.avg_pool2d(x, 2)
    x1 = act(_conv(p["conv1"], x, prec, 1))
    x21 = torch.cat([x, x1], 1)
    x22 = act(_conv(p["conv22"], _conv(p["conv21"], x21, prec), prec, 1))
    x31 = torch.cat([x21, x22], 1)
    return _bn(p["bn"], act(_conv(p["conv32"], _conv(p["conv31"], x31, prec), prec, 1)))


def _up(p, skip, x, prec):
    act = lambda t: F.leaky_relu(t, 0.01)  # noqa: E731
    x = torch.cat([F.interpolate(x, scale_factor=2, mode="nearest"), skip], 1)
    x1 = act(_conv(p["conv12"], _conv(p["conv11"], x, prec), prec, 1))
    x21 = torch.cat([x, x1], 1)
    return act(_conv(p["conv22"], _conv(p["conv21"], x21, prec), prec, 1))


def ritnet_logits(params: dict, x: torch.Tensor, prec: Precision = F32) -> torch.Tensor:
    """(B, 1, H, W) preprocessed input -> (B, 4, H, W) logits."""
    d1 = _down(params["down1"], x, False, prec)
    d2 = _down(params["down2"], d1, True, prec)
    d3 = _down(params["down3"], d2, True, prec)
    d4 = _down(params["down4"], d3, True, prec)
    d5 = _down(params["down5"], d4, True, prec)
    u = _up(params["up1"], d4, d5, prec)
    u = _up(params["up2"], d3, u, prec)
    u = _up(params["up3"], d2, u, prec)
    u = _up(params["up4"], d1, u, prec)
    return _conv(params["out_conv"], u, prec)


def segment_logits(params: dict, frames: torch.Tensor, prec: Precision = F32, chunk: int = 16) -> torch.Tensor:
    """(B, H, W, 1) frames in [0, 1] -> (B, 4, H, W) logits, ``chunk``
    frames at a time."""
    return torch.cat([ritnet_logits(params, preprocess(frames[i:i + chunk]), prec)
                      for i in range(0, frames.shape[0], chunk)])
