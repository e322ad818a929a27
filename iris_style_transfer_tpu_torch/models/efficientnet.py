"""EfficientNet-B7 U-Net for 4-class eye segmentation, inference only.

Counterpart of ``iris_style_transfer_tpu/models/efficientnet.py``
(reference ``smp.Unet(encoder_name='efficientnet-b7', classes=4)``, frozen):

  * encoder: EfficientNet-B7 (width 2.0, depth 3.1): stem conv3x3/2 -> 64,
    55 MBConv blocks (expand 1x1, depthwise kxk, squeeze-excite, project
    1x1, residual when ``stride == 1 and cin == cout``), SiLU, TF-"same"
    padding, batchnorm eps 1e-3;
  * skips at /2 /4 /8 /16 /32 (64, 48, 80, 224, 640 channels);
  * decoder: 5 blocks of nearest x2 upsample, skip concat and two
    conv3x3 + batchnorm (eps 1e-5) + ReLU, channels (256, 128, 64, 32, 16);
  * head: conv3x3 -> 4 classes.

``apply`` pads the height 400 -> 416, ImageNet-normalizes in float32, casts
to the compute dtype, averages the logits with those of the horizontally
flipped frame, takes the argmax and crops the pad back.

Activations are NCHW with channels_last memory.  Every stride-1 depthwise
conv with its batchnorm and SiLU is the fused op ``ops/depthwise.py``: on a
CUDA device always the hand-written kernel, 51 launches per forward.  The
stem and the four stride-2 depthwise convs keep TF-"same" padding, which is
asymmetric at stride 2, as ``F.pad`` plus ``F.conv2d``.  As in the JAX
package, neither the stem conv nor the depthwise convs add their ``b``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..ops.depthwise import dw_conv_bn_silu
from ..ops.image import imagenet_normalize, pad_height
from ..runtime.profiler import span
from . import layers as L

# B0 base: (expand, kernel, stride, cin, cout, repeats)
_BASE_BLOCKS = [
    (1, 3, 1, 32, 16, 1),
    (6, 3, 2, 16, 24, 2),
    (6, 5, 2, 24, 40, 2),
    (6, 3, 2, 40, 80, 3),
    (6, 5, 1, 80, 112, 3),
    (6, 5, 2, 112, 192, 4),
    (6, 3, 1, 192, 320, 1),
]
_WIDTH, _DEPTH = 2.0, 3.1  # B7
_BN_EPS = 1e-3

DECODER_CHANNELS = (256, 128, 64, 32, 16)
NUM_CLASSES = 4


def _round_filters(c: int) -> int:
    c *= _WIDTH
    new_c = max(8, int(c + 4) // 8 * 8)
    if new_c < 0.9 * c:
        new_c += 8
    return int(new_c)


def _round_repeats(r: int) -> int:
    return int(math.ceil(_DEPTH * r))


def block_args() -> list[tuple[int, int, int, int, int]]:
    """Expanded per-block args for B7: (expand, kernel, stride, cin, cout)."""
    out = []
    for expand, k, s, cin, cout, reps in _BASE_BLOCKS:
        cin, cout = _round_filters(cin), _round_filters(cout)
        for i in range(_round_repeats(reps)):
            out.append((expand, k, s if i == 0 else 1, cin if i == 0 else cout, cout))
    return out


BLOCK_ARGS = block_args()
STEM_CHANNELS = _round_filters(32)  # 64


def depthwise_shapes(height: int = 416, width: int = 640) -> dict[tuple[int, int, int, int], int]:
    """(k, C, H, W) of the stride-1 depthwise convs (the ones that take
    ``dw_conv_bn_silu``) of one forward on a padded ``height`` x ``width``
    frame, and how many blocks take each."""
    h, w = -(-height // 2), -(-width // 2)  # after the stride-2 stem
    shapes: dict[tuple[int, int, int, int], int] = {}
    for e, k, s, cin, _ in BLOCK_ARGS:
        if s == 1:
            shapes[(k, cin * e, h, w)] = shapes.get((k, cin * e, h, w), 0) + 1
        else:
            h, w = -(-h // 2), -(-w // 2)
    return shapes


def _skip_indices() -> list[int]:
    """Encoder taps (smp's stage splits for efficientnet-b7): just before
    every stride-2 block except the first (the stem output is the /2 tap),
    plus the final block."""
    down = [i for i, (_, _, s, _, _) in enumerate(BLOCK_ARGS) if s == 2]
    return [i - 1 for i in down[1:]] + [len(BLOCK_ARGS) - 1]


SKIP_AFTER = _skip_indices()


def _same_pad(in_h: int, in_w: int, k: int, s: int) -> list[tuple[int, int]]:
    """TF-"same" padding ``[(top, bottom), (left, right)]``."""

    def axis(n):
        pad = max((math.ceil(n / s) - 1) * s + k - n, 0)
        return (pad // 2, pad - pad // 2)

    return [axis(in_h), axis(in_w)]


def _conv_same(x: torch.Tensor, w: torch.Tensor, stride: int, groups: int = 1) -> torch.Tensor:
    """Bias-free conv with TF-"same" padding (asymmetric at stride 2)."""
    (top, bottom), (left, right) = _same_pad(x.shape[2], x.shape[3], w.shape[-1], stride)
    x = F.pad(x, (left, right, top, bottom))
    return F.conv2d(x, w.to(x.dtype), stride=stride, groups=groups)


def _conv_bias0(gen, k, cin, cout, device, dtype) -> dict:
    """Conv weights in torch's default init with a zero bias (the JAX
    package's seeded B7 init)."""
    return {"w": L.init_conv(gen, k, k, cin, cout, device, dtype)["w"],
            "b": torch.zeros(cout, device=device, dtype=dtype)}


def _init_mbconv(gen, expand, k, cin, cout, device, dtype):
    mid = cin * expand
    se = max(1, int(cin * 0.25))
    p = {}
    if expand != 1:
        p["expand_conv"] = _conv_bias0(gen, 1, cin, mid, device, dtype)
        p["bn0"] = L.init_batchnorm(mid, device, dtype)
    p["dw_conv"] = _conv_bias0(gen, k, 1, mid, device, dtype)
    p["bn1"] = L.init_batchnorm(mid, device, dtype)
    p["se_reduce"] = L.init_conv(gen, 1, 1, mid, se, device, dtype)
    p["se_expand"] = L.init_conv(gen, 1, 1, se, mid, device, dtype)
    p["project_conv"] = _conv_bias0(gen, 1, mid, cout, device, dtype)
    p["bn2"] = L.init_batchnorm(cout, device, dtype)
    return p


def _fold_bn(bn: dict, eps: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Eval batchnorm as a per-channel f32 affine ``(a, b)``."""
    a = bn["scale"].float() * torch.rsqrt(bn["var"].float() + eps)
    return a, bn["bias"].float() - bn["mean"].float() * a


def _mbconv(p, x, expand, k, stride, cin, cout):
    inp = x
    mid = cin * expand
    if expand != 1:
        x = L.conv2d(x, p["expand_conv"])
        x = F.silu(L.batchnorm(x, p["bn0"], eps=_BN_EPS))
    if stride == 1:
        # symmetric (k-1)/2 padding is TF-"same" at stride 1
        a, b = _fold_bn(p["bn1"], _BN_EPS)
        x = dw_conv_bn_silu(x, p["dw_conv"]["w"], a, b, k)
    else:
        x = _conv_same(x, p["dw_conv"]["w"], stride, groups=mid)
        x = F.silu(L.batchnorm(x, p["bn1"], eps=_BN_EPS))
    # squeeze-excite
    sq = x.mean(dim=(2, 3), keepdim=True)
    sq = F.silu(L.conv2d(sq, p["se_reduce"]))
    sq = torch.sigmoid(L.conv2d(sq, p["se_expand"]))
    x = x * sq
    # project
    x = L.batchnorm(L.conv2d(x, p["project_conv"]), p["bn2"], eps=_BN_EPS)
    if stride == 1 and cin == cout:
        x = x + inp  # drop-connect is the identity in eval
    return x


def _init_decoder_block(gen, cin, skip, cout, device, dtype):
    return {
        "conv1": _conv_bias0(gen, 3, cin + skip, cout, device, dtype),
        "bn1": L.init_batchnorm(cout, device, dtype),
        "conv2": _conv_bias0(gen, 3, cout, cout, device, dtype),
        "bn2": L.init_batchnorm(cout, device, dtype),
    }


def _decoder_block(p, x, skip):
    x = L.upsample_nearest(x, 2)
    if skip is not None:
        x = torch.cat([x, skip], dim=1)
    x = torch.relu(L.batchnorm(L.conv2d(x, p["conv1"], padding=1), p["bn1"]))
    return torch.relu(L.batchnorm(L.conv2d(x, p["conv2"], padding=1), p["bn2"]))


class EfficientNet:
    """smp-style Unet(efficientnet-b7): ``labels = EfficientNet.apply(params, frames)``."""

    @staticmethod
    def init(gen: torch.Generator, device="cpu", dtype=torch.float32) -> dict:
        """Seeded init in the JAX package's distribution (torch's default
        conv init, identity batchnorm, zero conv biases except SE)."""
        params = {
            "stem_conv": _conv_bias0(gen, 3, 3, STEM_CHANNELS, device, dtype),
            "stem_bn": L.init_batchnorm(STEM_CHANNELS, device, dtype),
            "blocks": [_init_mbconv(gen, e, k, cin, cout, device, dtype)
                       for e, k, _, cin, cout in BLOCK_ARGS],
        }
        skip_ch = [STEM_CHANNELS] + [BLOCK_ARGS[i][4] for i in SKIP_AFTER]
        enc = skip_ch[::-1]  # [640, 224, 80, 48, 64]
        skips = enc[1:] + [0]
        dec, cin = [], enc[0]
        for i, cout in enumerate(DECODER_CHANNELS):
            dec.append(_init_decoder_block(gen, cin, skips[i], cout, device, dtype))
            cin = cout
        params["decoder"] = dec
        params["head"] = L.init_conv(gen, 3, 3, DECODER_CHANNELS[-1], NUM_CLASSES, device, dtype)
        return params

    @staticmethod
    def encoder(params: dict, x: torch.Tensor) -> list[torch.Tensor]:
        """Features at reductions [/2, /4, /8, /16, /32] of an NCHW input."""
        h = _conv_same(x, params["stem_conv"]["w"], 2)
        h = F.silu(L.batchnorm(h, params["stem_bn"], eps=_BN_EPS))
        feats = [h]
        tap_set = set(SKIP_AFTER)
        for i, (bp, (e, k, s, cin, cout)) in enumerate(zip(params["blocks"], BLOCK_ARGS)):
            h = _mbconv(bp, h, e, k, s, cin, cout)
            if i in tap_set:
                feats.append(h)
        return feats

    @staticmethod
    def logits(params: dict, x: torch.Tensor) -> torch.Tensor:
        """(B, 3, H, W) normalized input, H and W divisible by 32 ->
        (B, 4, H, W) logits."""
        feats = EfficientNet.encoder(params, x)
        h = feats[-1]
        skips = feats[:-1][::-1] + [None]
        for dp, skip in zip(params["decoder"], skips):
            h = _decoder_block(dp, h, skip)
        return L.conv2d(h, params["head"], padding=1)

    @staticmethod
    def apply(params: dict, x: torch.Tensor, compute_dtype=torch.float32) -> torch.Tensor:
        """Grayscale or RGB frames (B, H, W, C) in [0,1] -> (B, H, W) int32
        labels.  Pads the height by 8 + 8, ImageNet-normalizes, averages
        the logits with the horizontal-flip pass's, argmax, crops the pad.
        Under a profiler a span ``b7.apply``."""
        with span("b7.apply"):
            if x.dim() == 3:
                x = x[None]
            if x.shape[-1] == 1:
                x = x.repeat_interleave(3, dim=-1)
            h = pad_height(x, 8, 8).float().permute(0, 3, 1, 2)
            h = imagenet_normalize(h).to(compute_dtype).contiguous(memory_format=torch.channels_last)
            o = EfficientNet.logits(params, h)
            o2 = EfficientNet.logits(params, torch.flip(h, dims=(3,)))
            o = (o + torch.flip(o2, dims=(3,))) / 2.0
            labels = torch.argmax(o, dim=1).to(torch.int32)
            return labels[:, 8:-8, :]
