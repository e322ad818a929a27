"""Write the image fixtures of the port's decoders, and their manifest.

    python tests/torch_fixtures/make_fixtures.py

PIL writes every file: JPEGs of twin eye frames (``data/synthetic.py``,
400x640; colour ones tinted) and of the JAX NST demo's procedural images
(the port's copy, ``demos/nst_demo.py:procedural_image``, 512x512), and
small PNGs in the forms the port's PNG reader gained (palette with tRNS,
1-bit and 16-bit gray).  ``manifest.json`` holds each file's form, the
shape of ``utils/decode.py:read_image(path)`` and the SHA-256 of PIL's
decode of it (``convert("RGB")`` for colour and palette files, else
``convert("L")``), and of PIL's ``convert("L")`` under ``gray_sha256``.
For the 16-bit gray PNG, where PIL's ``convert("L")`` clips at 255, both
are the SHA-256 of libpng's high bytes instead.  ``tests/test_torch_jpeg.py``
holds the committed files to the manifest; ``chip_smoke.py`` holds the
port's decode of them to it on the card's host.
"""

import hashlib
import json
import os
import sys

import numpy as np
from PIL import Image

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))

from iris_style_transfer_tpu_torch.data.synthetic import synthetic_eye_batch  # noqa: E402
from iris_style_transfer_tpu_torch.demos.nst_demo import procedural_image  # noqa: E402


def eye(seed: int) -> np.ndarray:
    """A 400x640 uint8 twin frame."""
    return np.round(synthetic_eye_batch(1, 400, 640, seed=seed)[0][0, ..., 0] * 255).astype(np.uint8)


def tint(gray: np.ndarray) -> np.ndarray:
    """A skin-toned colour version of a gray frame."""
    g = gray.astype(np.float32)
    return np.clip(np.stack([g * 1.05 + 12, g * 0.9 + 4, g * 0.78], axis=-1), 0, 255).astype(np.uint8)


def u8(img: np.ndarray) -> np.ndarray:
    return np.round(img * 255).astype(np.uint8)


# name -> (array, PIL mode, save options, form)
JPEGS = {
    "twin_gray_400x640.jpg": (eye(0), "L", {"quality": 90}, "JPEG gray baseline"),
    "twin_color_420_400x640.jpg": (tint(eye(1)), "RGB", {"quality": 90, "subsampling": 2},
                                   "JPEG colour 4:2:0 baseline"),
    "twin_color_progressive_400x640.jpg": (tint(eye(1)), "RGB", {"quality": 90, "subsampling": 2,
                                                                  "progressive": True},
                                           "JPEG colour 4:2:0 progressive"),
    "content_512.jpg": (u8(procedural_image(512, 1)), "RGB", {"quality": 85, "subsampling": 0},
                        "JPEG colour 4:4:4 baseline"),
    "style_512.jpg": (u8(procedural_image(512, 2)), "RGB", {"quality": 85, "subsampling": 2, "progressive": True,
                                                            "restart_marker_blocks": 5},
                      "JPEG colour 4:2:0 progressive, restart interval 5"),
    "eye_content.jpg": (eye(3), "L", {"quality": 85, "restart_marker_rows": 1}, "JPEG gray baseline, restart rows"),
    "eye_style.jpg": (tint(eye(4)), "RGB", {"quality": 85, "subsampling": 1, "progressive": True, "optimize": True},
                      "JPEG colour 4:2:2 progressive, optimized tables"),
}


def pngs() -> dict:
    crop = eye(5)[150:214, 250:346]  # 64x96 around the iris
    pal = Image.fromarray(tint(crop)).quantize(16)
    return {
        "palette_4bit_trns.png": (pal, {"bits": 4, "transparency": 3}, "PNG palette 4-bit, tRNS"),
        "gray_1bit.png": (Image.fromarray(crop > 100), {}, "PNG gray 1-bit"),
        "gray_16bit.png": (Image.fromarray(crop.astype(np.uint16) * 257 + np.arange(96, dtype=np.uint16)), {},
                           "PNG gray 16-bit"),
    }


def sha(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def main() -> None:
    entries = []
    for name, (arr, mode, opts, form) in JPEGS.items():
        Image.fromarray(arr, mode).save(os.path.join(HERE, name), "JPEG", **opts)
    for name, (im, opts, form) in pngs().items():
        im.save(os.path.join(HERE, name), "PNG", **opts)
    forms = {n: v[-1] for n, v in {**JPEGS, **pngs()}.items()}
    for name in sorted(forms):
        with Image.open(os.path.join(HERE, name)) as im:
            if im.mode == "I;16":  # libpng's png_set_strip_16: the high byte
                own = gray = (np.asarray(im).astype(np.uint16) >> 8).astype(np.uint8)[..., None]
            else:
                own = np.asarray(im.convert("RGB" if im.mode in ("RGB", "P") else "L"))
                own = own if own.ndim == 3 else own[..., None]
                gray = np.asarray(im.convert("L"))
        entries.append({"file": name, "form": forms[name], "shape": list(own.shape), "sha256": sha(own),
                        "gray_sha256": sha(gray)})
    with open(os.path.join(HERE, "manifest.json"), "w") as fh:
        json.dump({"files": entries}, fh, indent=1)
        fh.write("\n")


if __name__ == "__main__":
    main()
