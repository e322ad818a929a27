"""The EfficientNet-B7 U-Net (``smp.Unet('efficientnet-b7', classes=4)``)
for 4-class eye segmentation at 400x640, in plain float32 PyTorch.

Encoder: EfficientNet-B7 (Tan and Le 2019; width 2.0, depth 3.1): a 3x3
stride-2 stem to 64 channels, 55 MBConv blocks (1x1 expand, kxk
depthwise, squeeze-excite at a quarter of the block's input width, 1x1
project, a residual where stride 1 and widths agree), SiLU, batchnorm eps
1e-3, TF-"same" padding (asymmetric at stride 2); neither the stem nor the
depthwise convolutions add a bias.  Skips at /2 .. /32.  Decoder: five
blocks of nearest x2 upsample, skip concat, two 3x3 conv + batchnorm (eps
1e-5) + ReLU, widths 256, 128, 64, 32, 16; a 3x3 head to 4 classes.  The
frames are padded 8 + 8 rows (400 -> 416), ImageNet-normalized, and the
logits averaged with those of the horizontally flipped frame.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .precision import F32, Precision

BASE = [(1, 3, 1, 32, 16, 1), (6, 3, 2, 16, 24, 2), (6, 5, 2, 24, 40, 2), (6, 3, 2, 40, 80, 3),
        (6, 5, 1, 80, 112, 3), (6, 5, 2, 112, 192, 4), (6, 3, 1, 192, 320, 1)]
WIDTH, DEPTH = 2.0, 3.1
DECODER = (256, 128, 64, 32, 16)
MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)


def filters(c: int) -> int:
    c *= WIDTH
    n = max(8, int(c + 4) // 8 * 8)
    return int(n + 8 if n < 0.9 * c else n)


def blocks() -> list[tuple[int, int, int, int, int]]:
    """(expand, kernel, stride, C_in, C_out) of the 55 blocks."""
    out = []
    for e, k, s, ci, co, r in BASE:
        ci, co = filters(ci), filters(co)
        for i in range(int(math.ceil(DEPTH * r))):
            out.append((e, k, s if i == 0 else 1, ci if i == 0 else co, co))
    return out


def skips() -> list[int]:
    down = [i for i, b in enumerate(blocks()) if b[2] == 2]
    return [i - 1 for i in down[1:]] + [len(blocks()) - 1]


def shapes() -> dict:
    """The parameter tree's shapes, in the port's layout (OIHW convs)."""
    conv = lambda co, ci, k: {"w": (co, ci, k, k), "b": (co,)}  # noqa: E731
    bn = lambda c: {"scale": (c,), "bias": (c,), "mean": (c,), "var": (c,)}  # noqa: E731
    stem = filters(32)
    tree = {"stem_conv": conv(stem, 3, 3), "stem_bn": bn(stem), "blocks": []}
    for e, k, _, ci, co in blocks():
        mid, se = ci * e, max(1, int(ci * 0.25))
        b = {}
        if e != 1:
            b.update(expand_conv=conv(mid, ci, 1), bn0=bn(mid))
        b.update(dw_conv=conv(mid, 1, k), bn1=bn(mid), se_reduce=conv(se, mid, 1), se_expand=conv(mid, se, 1),
                 project_conv=conv(co, mid, 1), bn2=bn(co))
        tree["blocks"].append(b)
    enc = ([stem] + [blocks()[i][4] for i in skips()])[::-1]
    skip_ch = enc[1:] + [0]
    tree["decoder"], cin = [], enc[0]
    for i, co in enumerate(DECODER):
        tree["decoder"].append({"conv1": conv(co, cin + skip_ch[i], 3), "bn1": bn(co), "conv2": conv(co, co, 3),
                                "bn2": bn(co)})
        cin = co
    tree["head"] = conv(4, DECODER[-1], 3)
    return tree


def _bn(p, x, eps):
    v = lambda k: p[k].float().view(1, -1, 1, 1)  # noqa: E731
    return (x - v("mean")) / torch.sqrt(v("var") + eps) * v("scale") + v("bias")


def _conv(x, w, b, prec: Precision, stride=1, padding=0, groups=1):
    return prec.q("low", F.conv2d(prec.q("low", x), prec.q("low", w.float()), None if b is None else b.float(),
                                  stride=stride, padding=padding, groups=groups))


def _same(x, w, stride, prec, groups=1):
    k = w.shape[-1]

    def pads(n):
        p = max((math.ceil(n / stride) - 1) * stride + k - n, 0)
        return p // 2, p - p // 2

    (t, b), (lft, r) = pads(x.shape[2]), pads(x.shape[3])
    return _conv(F.pad(x, (lft, r, t, b)), w, None, prec, stride=stride, groups=groups)


def _mbconv(p, x, e, k, s, ci, co, prec):
    inp = x
    if e != 1:
        x = F.silu(_bn(p["bn0"], _conv(x, p["expand_conv"]["w"], p["expand_conv"]["b"], prec), 1e-3))
    x = F.silu(_bn(p["bn1"], _same(x, p["dw_conv"]["w"], s, prec, groups=x.shape[1]), 1e-3))
    sq = x.mean((2, 3), keepdim=True)
    sq = F.silu(_conv(sq, p["se_reduce"]["w"], p["se_reduce"]["b"], prec))
    x = x * torch.sigmoid(_conv(sq, p["se_expand"]["w"], p["se_expand"]["b"], prec))
    x = _bn(p["bn2"], _conv(x, p["project_conv"]["w"], p["project_conv"]["b"], prec), 1e-3)
    return x + inp if s == 1 and ci == co else x


def logits(params: dict, x: torch.Tensor, prec: Precision = F32) -> torch.Tensor:
    """(B, 3, H, W) normalized input -> (B, 4, H, W) logits."""
    h = F.silu(_bn(params["stem_bn"], _same(x, params["stem_conv"]["w"], 2, prec), 1e-3))
    feats, taps = [h], set(skips())
    for i, (bp, args) in enumerate(zip(params["blocks"], blocks())):
        h = _mbconv(bp, h, *args, prec)
        if i in taps:
            feats.append(h)
    h = feats[-1]
    for dp, skip in zip(params["decoder"], feats[:-1][::-1] + [None]):
        h = F.interpolate(h, scale_factor=2, mode="nearest")
        if skip is not None:
            h = torch.cat([h, skip], 1)
        h = torch.relu(_bn(dp["bn1"], _conv(h, dp["conv1"]["w"], dp["conv1"]["b"], prec, padding=1), 1e-5))
        h = torch.relu(_bn(dp["bn2"], _conv(h, dp["conv2"]["w"], dp["conv2"]["b"], prec, padding=1), 1e-5))
    return _conv(h, params["head"]["w"], params["head"]["b"], prec, padding=1)


def segment_logits(params: dict, frames: torch.Tensor, prec: Precision = F32, chunk: int = 8) -> torch.Tensor:
    """(B, H, W, 1) frames in [0, 1] -> (B, 4, H, W) flip-averaged logits."""
    mean = torch.tensor(MEAN, device=frames.device).view(1, 3, 1, 1)
    std = torch.tensor(STD, device=frames.device).view(1, 3, 1, 1)
    out = []
    for i in range(0, frames.shape[0], chunk):
        x = F.pad(frames[i:i + chunk].float(), (0, 0, 0, 0, 8, 8)).expand(-1, -1, -1, 3).permute(0, 3, 1, 2)
        x = (x - mean) / std
        o = (logits(params, x, prec) + logits(params, x.flip(3), prec).flip(3)) / 2
        out.append(o[:, :, 8:-8])
    return torch.cat(out)
