"""ResNet50's trunk (He et al. 2016, torchvision's v1.5: the stride on each
stage's first 3x3) to its 2048 pooled features, in plain float32 PyTorch;
eval batchnorm, ImageNet normalization inside the forward."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .precision import F32, Precision

STAGES = [(64, 3, 1), (128, 4, 2), (256, 6, 2), (512, 3, 2)]
MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)


def shapes() -> dict:
    conv = lambda co, ci, k: {"w": (co, ci, k, k), "b": (co,)}  # noqa: E731
    bn = lambda c: {"scale": (c,), "bias": (c,), "mean": (c,), "var": (c,)}  # noqa: E731
    tree, cin = {"conv1": conv(64, 3, 7), "bn1": bn(64)}, 64
    for si, (w, n, s) in enumerate(STAGES, start=1):
        stage = []
        for b in range(n):
            blk = {"conv1": conv(w, cin, 1), "bn1": bn(w), "conv2": conv(w, w, 3), "bn2": bn(w),
                   "conv3": conv(4 * w, w, 1), "bn3": bn(4 * w)}
            if b == 0:
                blk["downsample"] = {"conv": conv(4 * w, cin, 1), "bn": bn(4 * w)}
            stage.append(blk)
            cin = 4 * w
        tree[f"layer{si}"] = stage
    return tree


def _bn(p, x):
    v = lambda k: p[k].float().view(1, -1, 1, 1)  # noqa: E731
    return (x - v("mean")) / torch.sqrt(v("var") + 1e-5) * v("scale") + v("bias")


def _conv(p, x, prec: Precision, stride=1, padding=0):
    return prec.q("low", F.conv2d(prec.q("low", x), prec.q("low", p["w"].float()), p["b"].float(),
                                  stride=stride, padding=padding))


def features(params: dict, rgb: torch.Tensor, prec: Precision = F32) -> torch.Tensor:
    """(B, H, W, 3) images in [0, 1] -> (B, 2048)."""
    mean = torch.tensor(MEAN, device=rgb.device).view(1, 3, 1, 1)
    std = torch.tensor(STD, device=rgb.device).view(1, 3, 1, 1)
    h = (rgb.float().permute(0, 3, 1, 2) - mean) / std
    h = torch.relu(_bn(params["bn1"], _conv(params["conv1"], h, prec, 2, 3)))
    h = F.max_pool2d(h, 3, 2, padding=1)
    for si, (_, _, s) in enumerate(STAGES, start=1):
        for b, p in enumerate(params[f"layer{si}"]):
            st = s if b == 0 else 1
            y = torch.relu(_bn(p["bn1"], _conv(p["conv1"], h, prec)))
            y = torch.relu(_bn(p["bn2"], _conv(p["conv2"], y, prec, st, 1)))
            y = _bn(p["bn3"], _conv(p["conv3"], y, prec))
            if "downsample" in p:
                h = _bn(p["downsample"]["bn"], _conv(p["downsample"]["conv"], h, prec, st))
            h = torch.relu(y + h)
    return h.mean((2, 3))
