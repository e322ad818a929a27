"""The reference against the port at a tiny size on the CPU, float32: the
two are written apart, so agreement here says both compute the function
the configuration names."""

import math

import numpy as np
import torch

from benchmark import weights
from benchmark.reference import b7 as ref_b7
from benchmark.reference import gaze as ref_gaze
from benchmark.reference import image as ref_image
from benchmark.reference import lbfgs as ref_lbfgs
from benchmark.reference import resnet as ref_resnet
from benchmark.reference import ritnet as ref_ritnet
from benchmark.reference import vgg as ref_vgg
from benchmark.reference.precision import CONTROL, F32

from iris_style_transfer_tpu_torch.models import Classifier1, Classifier2, EfficientNet, RITnet, VGG19
from iris_style_transfer_tpu_torch.models.resnet import ResNet50
from iris_style_transfer_tpu_torch.ops.ellipse import extract_eye_landmarks
from iris_style_transfer_tpu_torch.ops.image import composite_iris, crop_and_resize, nonzero_bbox, rgb_to_grayscale
from iris_style_transfer_tpu_torch.transfer.lbfgs import lbfgs_init, lbfgs_step


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


def test_vgg19_and_heads():
    vgg = weights.vgg19(3, "cpu")
    c1, c2 = weights.mlp_heads(3, [(25088, 4096, 4096, 10), (1920, 4096, 4096, 10)], "cpu")
    x = torch.rand(2, 3, 224, 224, generator=torch.Generator().manual_seed(0))
    final, _, style = VGG19.apply(vgg, x)
    r1, r2 = ref_vgg.classifiers(vgg, c1, c2, x)
    assert _rel(Classifier1.apply(c1, final), r1) < 1e-4
    assert _rel(Classifier2.apply(c2, style), r2) < 1e-4
    _, taps = ref_vgg.vgg_features(vgg, x, taps=ref_vgg.STYLE)
    assert all(_rel(p, taps[n]) < 1e-5 for p, n in zip(style, ref_vgg.STYLE))


def test_ritnet_labels():
    path = ref_ritnet.__file__.rsplit("/benchmark/", 1)[0] + "/iris_style_transfer_tpu/models/weights/ritnet.npz"
    frames = torch.rand(2, 64, 96, 1, generator=torch.Generator().manual_seed(1))
    ours = ref_ritnet.segment_logits(ref_ritnet.load_ritnet(path, "cpu"), frames)
    port = RITnet.forward(RITnet.pretrained("cpu"), RITnet.transform(frames))
    assert _rel(ours, port) < 1e-4
    assert bool((ours.argmax(1) == RITnet.apply(RITnet.pretrained("cpu"), frames)).all())


def test_crop_and_composite():
    g = torch.Generator().manual_seed(2)
    frames = torch.rand(3, 40, 64, 1, generator=g)
    masks = torch.rand(3, 40, 64, generator=g) > 0.7
    masks[2] = False
    boxes = ref_image.bbox(masks)
    assert bool((boxes == nonzero_bbox(masks).long()).all())
    ours = ref_image.crop(frames * masks[..., None], boxes, (24, 24))
    assert _rel(ours, crop_and_resize(frames * masks[..., None], boxes.int(), (24, 24))) < 1e-5
    sty = torch.rand(3, 3, 24, 24, generator=g)
    port = composite_iris(frames, rgb_to_grayscale(sty.permute(0, 2, 3, 1)), masks[..., None], boxes.int())
    assert _rel(ref_image.composite(frames, sty, masks, boxes), port) < 1e-5


def _draw(tree, path=()):
    if isinstance(tree, dict):
        return {k: _draw(v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_draw(v, path) for v in tree]
    if path[-1] == "w":
        return torch.randn(tree) / math.sqrt(math.prod(tree[1:]))
    if path[-1] in ("scale", "var"):
        return torch.rand(tree) + 0.5
    return torch.randn(tree) * 0.1


def test_b7_resnet_and_landmarks():
    torch.manual_seed(0)
    p = _draw(ref_b7.shapes())
    frames = torch.rand(2, 48, 64, 1)
    assert bool((ref_b7.segment_logits(p, frames).argmax(1) == EfficientNet.apply(p, frames)).all())
    rp = _draw(ref_resnet.shapes())
    x = torch.rand(2, 64, 64, 3)
    assert _rel(ref_resnet.features(rp, x), ResNet50.apply(rp, x)) < 1e-5
    seg = torch.randint(0, 4, (3, 40, 60))
    seg[2] = 0
    assert float((ref_gaze.landmarks(seg) - extract_eye_landmarks(seg)).abs().max()) < 1e-4


def test_lbfgs_update_matches_the_port():
    """The reference's two-loop update against the port's compact one,
    on a quadratic, both in float32 with a float32 history."""
    g = torch.Generator().manual_seed(4)
    a = torch.rand(50, generator=g) + 0.5
    x = torch.rand(50, generator=g)
    state = lbfgs_init(50, 5)
    pairs, rhos, gamma, prev = [], [], 1.0, None
    for k in range(8):
        grad = a * x
        upd, state = lbfgs_step(state, grad)
        if k == 0:
            want = -grad * min(1.0, 1.0 / float(grad.abs().sum()))
        else:
            y, s = grad - prev[0], prev[1]
            ys = float((y * s).sum())
            if ys > 1e-10:
                pairs, rhos, gamma = (pairs + [(s, y)])[-5:], (rhos + [1 / ys])[-5:], ys / float((y * y).sum())
            want = ref_lbfgs.two_loop(pairs, rhos, gamma, grad)
        assert _rel(upd, want) < 1e-4
        prev = (grad, upd)
        x = x + upd


def test_control_is_lower_precision():
    x = torch.randn(1000, generator=torch.Generator().manual_seed(5))
    assert F32.q("low", x) is x
    err = (CONTROL.q("low", x) - x).abs().max() / x.abs().max()
    assert 1e-3 < float(err) < 0.1
    assert np.allclose(CONTROL.q("f32", x).numpy(), x.numpy(), rtol=2e-3)
