"""Convert a PyTorch checkpoint into the npz the port and the JAX package
read, without JAX.

    python -m iris_style_transfer_tpu_torch.tools.port_weights vgg19 vgg19-dcbb9e9d.pth vgg19.npz
    python -m iris_style_transfer_tpu_torch.tools.port_weights resnet50 resnet50.pth resnet50.npz
    python -m iris_style_transfer_tpu_torch.tools.port_weights efficientnet_unet unet_efficientnet-b7.pt \\
        unet_efficientnet-b7.npz
    python -m iris_style_transfer_tpu_torch.tools.port_weights classifier1|classifier2|gaze|ritnet head.pth out.npz

Counterpart of the repository's ``tools/port_weights.py`` (same kinds and
arguments).  The file is read with ``torch.load(weights_only=True)``: a
checkpoint that needs unpickling of anything but tensors and containers
raises with torch's message.  A ``{"state_dict": ...}`` wrapper is
unwrapped and a ``module.`` prefix (a DataParallel checkpoint) stripped;
the state dict goes through ``models/port.py``'s converter for ``kind``
and is written with ``save_npz`` in the JAX layout.  Put the result where
``models/pretrained.py`` looks, or pass it to a main's ``--*_weights``.
"""

from __future__ import annotations

import argparse

import torch

from ..models import port

CONVERTERS = {
    "vgg19": port.convert_vgg19,
    "resnet50": port.convert_resnet50,
    "efficientnet_unet": port.convert_efficientnet_unet,
    "classifier1": port.convert_classifier1,
    "classifier2": port.convert_classifier2,
    "gaze": port.convert_gaze_estimator,
    "ritnet": port.convert_ritnet,
}


def read_state_dict(src: str) -> dict:
    """The state dict of a checkpoint file, unwrapped and without a
    ``module.`` prefix."""
    obj = torch.load(src, weights_only=True, map_location="cpu")
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return {k.removeprefix("module."): v for k, v in obj.items()}


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("kind", choices=sorted(CONVERTERS))
    ap.add_argument("src", help="the PyTorch checkpoint (.pth / .pt / .pkl)")
    ap.add_argument("dst", help="the npz to write")
    args = ap.parse_args(argv)
    port.save_npz(args.dst, CONVERTERS[args.kind](read_state_dict(args.src)))
    print(f"wrote {args.dst}")


if __name__ == "__main__":
    main()
