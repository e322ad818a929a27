"""Seeded weights, made on the device in a few large draws, in the port's
parameter layout (dicts of OIHW convs and (out, in) linears), which the
reference reads as well.

VGG19 and ResNet50: He-normal (fan_out) convs with zero biases,
torchvision's own initialisation (ResNet50's batchnorm the identity);
the heads: ``nn.Linear``'s uniform(+-1/sqrt(fan_in)); the B7 U-Net: see
:func:`b7`.  The pretrained VGG19, B7 and ResNet50 and the trained heads
are not in the repository.
"""

from __future__ import annotations

import math

import torch

from .reference import b7 as ref_b7
from .reference import resnet as ref_resnet
from .reference.vgg import conv_names, widths
from .twin import generator


def _split(flat: torch.Tensor, shapes: list[tuple]) -> list[torch.Tensor]:
    out, at = [], 0
    for s in shapes:
        n = math.prod(s)
        out.append(flat[at:at + n].view(s))
        at += n
    return out


def vgg19(seed: int, device) -> dict:
    w = widths()
    shapes = [(cout, cin, 3, 3) for cin, cout in w.values()]
    flat = torch.randn(sum(math.prod(s) for s in shapes), generator=generator(seed, 10_001, device), device=device)
    params = {}
    for name, t, (cin, cout) in zip(conv_names(), _split(flat, shapes), w.values()):
        params[name] = {"w": t * math.sqrt(2.0 / (9 * cout)), "b": torch.zeros(cout, device=device)}
    return params


def mlp_heads(seed: int, dims: list[tuple[int, ...]], device) -> list[dict]:
    """One MLP per entry of ``dims`` (its layer widths), uniform init."""
    shapes = []
    for d in dims:
        for din, dout in zip(d[:-1], d[1:]):
            shapes += [(dout, din), (dout,)]
    flat = torch.rand(sum(math.prod(s) for s in shapes), generator=generator(seed, 10_002, device), device=device)
    parts = iter(_split(flat * 2 - 1, shapes))
    heads = []
    for d in dims:
        head = {}
        for i, (din, dout) in enumerate(zip(d[:-1], d[1:])):
            bound = 1.0 / math.sqrt(din)
            head[f"fc{i}"] = {"w": next(parts) * bound, "b": next(parts) * bound}
        heads.append(head)
    return heads


def b7(seed: int, device) -> dict:
    """B7's weights in three draws: convs at fan-in scale, batchnorm scale
    and variance in [0.5, 1.5), the rest N(0, 0.01)."""
    shapes = ref_b7.shapes()
    leaves = []

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, path) for v in node]
        leaves.append((path[-1], node))
        return len(leaves) - 1

    tree = walk(shapes, ())
    kinds = {"w": [], "u": [], "n": []}
    for i, (key, shape) in enumerate(leaves):
        kinds["w" if key == "w" else "u" if key in ("scale", "var") else "n"].append(i)
    g = generator(seed, 10_003, device)
    out = [None] * len(leaves)
    for kind, idx in kinds.items():
        sizes = [math.prod(leaves[i][1]) for i in idx]
        flat = torch.randn(sum(sizes), generator=g, device=device) if kind != "u" else \
            torch.rand(sum(sizes), generator=g, device=device)
        for i, part in zip(idx, flat.split(sizes)):
            shape = leaves[i][1]
            if kind == "w":
                out[i] = part.view(shape) / math.sqrt(math.prod(shape[1:]))
            elif kind == "u":
                out[i] = part.view(shape) + 0.5
            else:
                out[i] = part.view(shape) * 0.1

    def fill(node):
        if isinstance(node, dict):
            return {k: fill(v) for k, v in node.items()}
        if isinstance(node, list):
            return [fill(v) for v in node]
        return out[node]

    return fill(tree)


def resnet50(seed: int, device) -> dict:
    """ResNet50 as torchvision initialises it: He-normal (fan_out) convs,
    zero biases, identity batchnorm."""
    shapes = ref_resnet.shapes()
    convs = []

    def walk(node):
        if isinstance(node, list):
            for v in node:
                walk(v)
        elif isinstance(node, dict):
            if "w" in node:
                convs.append(node)
            else:
                for v in node.values():
                    walk(v)

    walk(shapes)
    flat = torch.randn(sum(math.prod(c["w"]) for c in convs), generator=generator(seed, 10_004, device),
                       device=device)
    parts = iter(flat.split([math.prod(c["w"]) for c in convs]))

    def build(node):
        if isinstance(node, list):
            return [build(v) for v in node]
        if "w" in node:
            co, _, k, _ = node["w"]
            return {"w": next(parts).view(node["w"]) * math.sqrt(2.0 / (k * k * co)),
                    "b": torch.zeros(co, device=device)}
        if "scale" in node:
            c = node["scale"][0]
            return {"scale": torch.ones(c, device=device), "bias": torch.zeros(c, device=device),
                    "mean": torch.zeros(c, device=device), "var": torch.ones(c, device=device)}
        return {k: build(v) for k, v in node.items()}

    return build(shapes)
