"""RITnet — DenseNet2D U-Net for 4-class eye segmentation.

Counterpart of ``iris_style_transfer_tpu/models/ritnet.py`` (reference
``models/ritnet/ritnet.py``): 5 dense down blocks (2x2 average-pool
downsampling), 4 dense up blocks (nearest x2 upsample + skip concat), a
1x1 output conv, LeakyReLU throughout, eval batchnorm at the down-block
outputs.  Preprocessing is gamma 0.8 LUT -> CLAHE(1.5, 8x8) ->
normalize(0.5, 0.5), batched on the device.  The bundled weights are read
by path from the JAX package's ``models/weights/ritnet.npz``.
"""

from __future__ import annotations

import os

import torch

from ..ops.clahe import clahe
from ..ops.image import gamma_lut
from . import layers as L
from .port import from_jax, load_npz
from .pretrained import WEIGHTS_DIR

CHANNELS = 32
NUM_CLASSES = 4
WEIGHTS_PATH = os.path.join(WEIGHTS_DIR, "ritnet.npz")


def _init_down_block(gen, cin, cout, device):
    return {
        "conv1": L.init_conv(gen, 3, 3, cin, cout, device),
        "conv21": L.init_conv(gen, 1, 1, cin + cout, cout, device),
        "conv22": L.init_conv(gen, 3, 3, cout, cout, device),
        "conv31": L.init_conv(gen, 1, 1, cin + 2 * cout, cout, device),
        "conv32": L.init_conv(gen, 3, 3, cout, cout, device),
        "bn": L.init_batchnorm(cout, device),
    }


def _init_up_block(gen, skip, cin, cout, device):
    return {
        "conv11": L.init_conv(gen, 1, 1, skip + cin, cout, device),
        "conv12": L.init_conv(gen, 3, 3, cout, cout, device),
        "conv21": L.init_conv(gen, 1, 1, skip + cin + cout, cout, device),
        "conv22": L.init_conv(gen, 3, 3, cout, cout, device),
    }


def _down_block(p, x, down: bool):
    if down:
        x = L.avg_pool(x, 2)
    x1 = L.leaky_relu(L.conv2d(x, p["conv1"], padding=1))
    x21 = torch.cat([x, x1], dim=1)
    x22 = L.leaky_relu(L.conv2d(L.conv2d(x21, p["conv21"]), p["conv22"], padding=1))
    x31 = torch.cat([x21, x22], dim=1)
    out = L.leaky_relu(L.conv2d(L.conv2d(x31, p["conv31"]), p["conv32"], padding=1))
    return L.batchnorm(out, p["bn"])


def _up_block(p, skip_feat, x):
    x = L.upsample_nearest(x, 2)
    x = torch.cat([x, skip_feat], dim=1)
    x1 = L.leaky_relu(L.conv2d(L.conv2d(x, p["conv11"]), p["conv12"], padding=1))
    x21 = torch.cat([x, x1], dim=1)
    return L.leaky_relu(L.conv2d(L.conv2d(x21, p["conv21"]), p["conv22"], padding=1))


class RITnet:
    """Functional RITnet: ``labels = RITnet.apply(params, frames)``."""

    @staticmethod
    def init(gen: torch.Generator, device="cpu") -> dict:
        c = CHANNELS
        params = {"down1": _init_down_block(gen, 1, c, device)}
        for i in range(2, 6):
            params[f"down{i}"] = _init_down_block(gen, c, c, device)
        for i in range(1, 5):
            params[f"up{i}"] = _init_up_block(gen, c, c, c, device)
        params["out_conv"] = L.init_conv(gen, 1, 1, c, NUM_CLASSES, device)
        return params

    @staticmethod
    def pretrained(device="cpu") -> dict:
        """The bundled weights (ported from the reference's pkl)."""
        return from_jax(load_npz(WEIGHTS_PATH), device=device, dtype=torch.float32)

    @staticmethod
    def transform(x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 1) frames in [0,1] -> (B, 1, H, W) network input:
        gamma 0.8 LUT -> CLAHE(1.5, 8x8) -> normalize(0.5, 0.5)."""
        y = clahe(gamma_lut(x, 0.8)[..., 0])
        return ((y - 0.5) / 0.5)[:, None]

    @staticmethod
    def forward(params: dict, x: torch.Tensor) -> torch.Tensor:
        """DenseNet2D on (B, 1, H, W) preprocessed input -> (B, 4, H, W) logits."""
        x1 = _down_block(params["down1"], x, down=False)
        x2 = _down_block(params["down2"], x1, down=True)
        x3 = _down_block(params["down3"], x2, down=True)
        x4 = _down_block(params["down4"], x3, down=True)
        x5 = _down_block(params["down5"], x4, down=True)
        x6 = _up_block(params["up1"], x4, x5)
        x7 = _up_block(params["up2"], x3, x6)
        x8 = _up_block(params["up3"], x2, x7)
        x9 = _up_block(params["up4"], x1, x8)
        return L.conv2d(x9, params["out_conv"])

    @staticmethod
    def apply(params: dict, x: torch.Tensor, preprocess: bool = True) -> torch.Tensor:
        """(B, H, W, 1) frames in [0,1] -> (B, H, W) int64 class labels."""
        if preprocess:
            x = RITnet.transform(x)
        return torch.argmax(RITnet.forward(params, x), dim=1)
