"""VGG19 (torchvision's ``features`` widths), the two classifier heads, the
BN-statistics NST loss, in plain float32 PyTorch.

Written from the published descriptions: VGG19 is Simonyan and
Zisserman's configuration E with ImageNet normalization inside the
forward; Classifier1 is AdaptiveAvgPool(7, 7), the NCHW flatten and an MLP
25088 -> 4096 -> 4096 -> classes; Classifier2 the same MLP over the
per-channel (mean || Bessel std) of relu1_1 .. relu4_1 (1920 features);
the NST loss is ``c_w * 0.5 * mean((F_c(x) - F_c(content))^2) + s_w *
sum_l sum_{b,c} ((mu_l(x) - mu_l(style))^2 + (sd_l(x) - sd_l(style))^2) /
C_l`` (its optimizer is in ``lbfgs.py``).  The 2x2 max-pool's gradient goes
in full to every element at its window's maximum, the convention of the
JAX package and the port (torch's own pool picks one), which matters on
the crops' constant zero background, where windows tie.  Images are NCHW in [0, 1].  Parameters are dicts of OIHW convs
and (out, in) linears.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .precision import F32, Precision

CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512, 512, 512, 512, "M", 512, 512, 512, 512, "M")
MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
CONTENT = ("relu4_2",)
STYLE = ("relu1_1", "relu2_1", "relu3_1", "relu4_1")


class _MaxPool2(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = F.max_pool2d(x, 2)
        ctx.save_for_backward(x, y)
        return y

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        up = lambda t: t.repeat_interleave(2, 2).repeat_interleave(2, 3)  # noqa: E731
        return torch.where(x == up(y), up(g), 0.0)


def max_pool2(x: torch.Tensor) -> torch.Tensor:
    return _MaxPool2.apply(x)


def conv_names() -> list[str]:
    names, block, i = [], 1, 1
    for c in CFG:
        if c == "M":
            block, i = block + 1, 1
        else:
            names.append(f"conv{block}_{i}")
            i += 1
    return names


def widths() -> dict[str, tuple[int, int]]:
    """conv name -> (C_in, C_out)."""
    out, cin = {}, 3
    for name, c in zip(conv_names(), [c for c in CFG if c != "M"]):
        out[name] = (cin, c)
        cin = c
    return out


def vgg_features(params: dict, x: torch.Tensor, taps=(), stop: str | None = None,
                 prec: Precision = F32) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """(final activation, {tap: activation}); ``stop`` ends the stack after
    that layer.  Each convolution's inputs, weights and output go through
    ``prec.q("low")``: the activations are held in that precision, as the
    program holds them in its compute type."""
    mean = torch.tensor(MEAN, device=x.device).view(1, 3, 1, 1)
    std = torch.tensor(STD, device=x.device).view(1, 3, 1, 1)
    h = (x.float() - mean) / std
    out: dict[str, torch.Tensor] = {}
    block, i = 1, 1
    for c in CFG:
        if c == "M":
            h = max_pool2(h)
            block, i = block + 1, 1
            continue
        p = params[f"conv{block}_{i}"]
        h = prec.q("low", F.conv2d(prec.q("low", h), prec.q("low", p["w"].float()), p["b"].float(), padding=1))
        h = torch.relu(h)
        name = f"relu{block}_{i}"
        if name in taps:
            out[name] = h
        if name == stop:
            return h, out
        i += 1
    return h, out


def channel_stats(f: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-channel spatial mean and Bessel-corrected std, (B, C) each."""
    return f.mean(dim=(2, 3)), f.std(dim=(2, 3), unbiased=True)


def _mlp(p: dict, x: torch.Tensor, prec: Precision) -> torch.Tensor:
    for k in ("fc0", "fc1", "fc2"):
        x = F.linear(prec.q("low", x), prec.q("low", p[k]["w"].float()), p[k]["b"].float())
        if k != "fc2":
            x = torch.relu(x)
    return x


def classifiers(vgg: dict, c1: dict, c2: dict, irises: torch.Tensor,
                prec: Precision = F32) -> tuple[torch.Tensor, torch.Tensor]:
    """Both heads' logits of (B, 3, 224, 224) iris crops."""
    final, taps = vgg_features(vgg, irises, taps=STYLE, prec=prec)
    x1 = F.adaptive_avg_pool2d(final, (7, 7)).flatten(1)
    x2 = torch.cat([torch.cat(channel_stats(taps[n]), dim=1) for n in STYLE], dim=1)
    return _mlp(c1, x1, prec), _mlp(c2, x2, prec)


class NSTLoss:
    """The BN-statistics NST loss against fixed content and style images."""

    def __init__(self, vgg: dict, content: torch.Tensor, style: torch.Tensor, c_w: float, s_w: float,
                 prec: Precision = F32):
        self.vgg, self.c_w, self.s_w, self.prec = vgg, c_w, s_w, prec
        with torch.no_grad():
            _, tc = vgg_features(vgg, content, taps=CONTENT, stop=CONTENT[-1], prec=prec)
            _, ts = vgg_features(vgg, style, taps=STYLE, stop=CONTENT[-1], prec=prec)
        self.content = [tc[n] for n in CONTENT]
        self.style = [channel_stats(ts[n]) for n in STYLE]

    def __call__(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(total, content, style) at x."""
        _, t = vgg_features(self.vgg, x, taps=CONTENT + STYLE, stop=CONTENT[-1], prec=self.prec)
        c = sum(0.5 * ((t[n] - tgt) ** 2).mean() for n, tgt in zip(CONTENT, self.content))
        s = 0.0
        for n, (tm, ts) in zip(STYLE, self.style):
            m, sd = channel_stats(t[n])
            s = s + (((m - tm) ** 2).sum() + ((sd - ts) ** 2).sum()) / m.shape[1]
        return self.c_w * c + self.s_w * s, c, s
