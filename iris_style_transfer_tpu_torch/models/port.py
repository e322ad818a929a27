"""Weight bridge between the JAX package's parameter pytrees and torch
tensors, both ways.

:func:`from_jax` is the inverse of ``iris_style_transfer_tpu/models/port.py``:
HWIO conv kernels become OIHW, (in, out) linear weights become (out, in),
and batchnorm ``{scale, bias, mean, var}`` leaves carry over unchanged.
:func:`to_jax` inverts :func:`from_jax`, so the port's checkpoints are
written in the JAX layout.  The npz reader and writer use the JAX package's
flattened key format (``'/'``-joined paths, all-digit segments for list
entries), so ``models/weights/ritnet.npz``, any ported ``--vgg_weights``
npz and the checkpoints of either package load without JAX.

The ``convert_*`` functions map a PyTorch state dict (numpy arrays or
tensors, under the source's key names: the bundled RITnet, torchvision's
VGG19 and ResNet50, smp's Unet(efficientnet-b7), the reference's heads)
straight into the port's parameter tree, the counterpart of the JAX
package's ``models/port.py`` converters; :func:`save_npz` writes such a
tree in the JAX layout.  ``tools/port_weights.py`` is their command line.
"""

from __future__ import annotations

import numpy as np
import torch


def _tensor(a, device, dtype) -> torch.Tensor:
    """A copy of an array or tensor on ``device``; floating point cast to
    ``dtype`` unless it is None."""
    t = a.detach().cpu().clone() if isinstance(a, torch.Tensor) else torch.from_numpy(np.array(a, order="C"))
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def _leaf(key: str, a, device, dtype) -> torch.Tensor:
    a = np.asarray(a)
    if key == "w" and a.ndim == 4:
        a = np.transpose(a, (3, 2, 0, 1))  # HWIO -> OIHW
    elif key == "w" and a.ndim == 2:
        a = np.transpose(a, (1, 0))  # (in, out) -> (out, in)
    return _tensor(a, device, dtype)


def from_jax(params, device="cpu", dtype=None):
    """Convert a JAX-layout parameter tree (nested dicts / lists of numpy
    arrays) into the same tree of torch tensors in torch layout."""

    def walk(node, key):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v, key) for v in node]
        return _leaf(key, node, device, dtype)

    return walk(params, "")


def _jax_leaf(key: str, t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        a = (t.float() if t.dtype == torch.bfloat16 else t).numpy()  # numpy has no bfloat16
    else:
        a = np.asarray(t)
    if key == "w" and a.ndim == 4:
        a = np.transpose(a, (2, 3, 1, 0))  # OIHW -> HWIO
    elif key == "w" and a.ndim == 2:
        a = np.transpose(a, (1, 0))  # (out, in) -> (in, out)
    return np.asarray(a, order="C")  # keeps 0-d leaves 0-d


def to_jax(params):
    """The inverse of :func:`from_jax`: a torch-layout tree (nested dicts /
    lists of tensors) as the same tree of numpy arrays in JAX layout."""

    def walk(node, key):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v, key) for v in node]
        return _jax_leaf(key, node)

    return walk(params, "")


def flatten_pytree(tree, prefix: str = "") -> dict[str, np.ndarray]:
    """Nested dicts / lists -> '/'-joined flat keys (list entries as
    all-digit segments), the JAX package's npz key format."""
    flat = {}
    items = enumerate(tree) if isinstance(tree, (list, tuple)) else tree.items()
    for k, v in items:
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, (dict, list, tuple)):
            flat.update(flatten_pytree(v, key))
        else:
            flat[key] = np.asarray(v)
    return flat


def unflatten_pytree(flat: dict) -> dict:
    """'/'-joined flat keys -> nested dicts; all-digit levels become lists."""
    tree: dict = {}
    for k, v in flat.items():
        parts = k.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v

    def listify(node):
        if not isinstance(node, dict):
            return node
        if node and all(key.isdigit() for key in node):
            return [listify(node[key]) for key in sorted(node, key=int)]
        return {k: listify(v) for k, v in node.items()}

    return listify(tree)


def load_npz(path: str) -> dict:
    """Read an npz written by the JAX package's ``save_npz`` into its
    (numpy, JAX-layout) tree; convert with :func:`from_jax`."""
    with np.load(path) as f:
        return unflatten_pytree({k: f[k] for k in f.files})


def save_npz(path: str, params) -> None:
    """Write a torch-layout tree as an npz in the JAX layout and key format,
    which both packages' ``load_npz`` read."""
    np.savez(path, **flatten_pytree(to_jax(params)))


# ---------------------------------------------------------------------------
# state dict -> torch-layout params (torch's own OIHW / (out, in) layouts,
# so the tensors carry over unchanged)
# ---------------------------------------------------------------------------


def _conv(sd, prefix, device, dtype, bias: bool = True) -> dict:
    """A conv's weight and bias; a zero bias where the source has none (or,
    with ``bias=False``, always: the depthwise convs)."""
    w = _tensor(sd[prefix + ".weight"], device, dtype)
    if bias and prefix + ".bias" in sd:
        return {"w": w, "b": _tensor(sd[prefix + ".bias"], device, dtype)}
    return {"w": w, "b": torch.zeros(w.shape[0], dtype=w.dtype, device=w.device)}


def _linear(sd, prefix, device, dtype) -> dict:
    return {"w": _tensor(sd[prefix + ".weight"], device, dtype), "b": _tensor(sd[prefix + ".bias"], device, dtype)}


def _bn(sd, prefix, device, dtype) -> dict:
    return {k: _tensor(sd[f"{prefix}.{src}"], device, dtype)
            for k, src in (("scale", "weight"), ("bias", "bias"), ("mean", "running_mean"), ("var", "running_var"))}


def convert_ritnet(sd: dict, device="cpu", dtype=None) -> dict:
    """The bundled RITnet state dict (``down_block1.conv1.weight``, ...)."""
    params = {}
    for i in range(1, 6):
        src = f"down_block{i}"
        params[f"down{i}"] = {n: _conv(sd, f"{src}.{n}", device, dtype)
                              for n in ("conv1", "conv21", "conv22", "conv31", "conv32")}
        params[f"down{i}"]["bn"] = _bn(sd, f"{src}.bn", device, dtype)
    for i in range(1, 5):
        params[f"up{i}"] = {n: _conv(sd, f"up_block{i}.{n}", device, dtype)
                            for n in ("conv11", "conv12", "conv21", "conv22")}
    params["out_conv"] = _conv(sd, "out_conv1", device, dtype)
    return params


def convert_vgg19(sd: dict, bn: bool = False, device="cpu", dtype=None) -> dict:
    """torchvision's VGG19 (``features.N.weight`` indices -> conv names);
    ``bn`` for VGG19_BN's indices and batchnorms."""
    from .vgg import CONV_NAMES, VGG19_BN_LAYERS, VGG19_LAYERS

    sd = {k.removeprefix("features."): v for k, v in sd.items() if "features." in k or k[0].isdigit()}
    table = VGG19_BN_LAYERS if bn else VGG19_LAYERS
    params = {}
    for name in CONV_NAMES:
        params[name] = _conv(sd, str(table[name]), device, dtype)
        if bn:
            bn_name = "bn" + name[4:]
            params[bn_name] = _bn(sd, str(table[bn_name]), device, dtype)
    return params


def convert_resnet50(sd: dict, device="cpu", dtype=None) -> dict:
    """torchvision's ResNet50."""
    from .resnet import STAGES

    params = {"conv1": _conv(sd, "conv1", device, dtype), "bn1": _bn(sd, "bn1", device, dtype)}
    for si, (_, blocks, _) in enumerate(STAGES, start=1):
        stage = []
        for b in range(blocks):
            pre = f"layer{si}.{b}"
            p = {}
            for j in (1, 2, 3):
                p[f"conv{j}"] = _conv(sd, f"{pre}.conv{j}", device, dtype)
                p[f"bn{j}"] = _bn(sd, f"{pre}.bn{j}", device, dtype)
            if f"{pre}.downsample.0.weight" in sd:
                p["downsample"] = {"conv": _conv(sd, f"{pre}.downsample.0", device, dtype),
                                   "bn": _bn(sd, f"{pre}.downsample.1", device, dtype)}
            stage.append(p)
        params[f"layer{si}"] = stage
    return params


def convert_efficientnet_unet(sd: dict, device="cpu", dtype=None) -> dict:
    """smp's Unet(efficientnet-b7); a ``module.`` prefix (a DataParallel
    checkpoint, reference ``efficientnet.py:22-24``) is stripped."""
    from .efficientnet import BLOCK_ARGS

    sd = {k.removeprefix("module."): v for k, v in sd.items()}
    params = {"stem_conv": _conv(sd, "encoder._conv_stem", device, dtype),
              "stem_bn": _bn(sd, "encoder._bn0", device, dtype)}
    blocks = []
    for i, (expand, *_) in enumerate(BLOCK_ARGS):
        pre = f"encoder._blocks.{i}"
        p = {}
        if expand != 1:
            p["expand_conv"] = _conv(sd, f"{pre}._expand_conv", device, dtype)
            p["bn0"] = _bn(sd, f"{pre}._bn0", device, dtype)
        p["dw_conv"] = _conv(sd, f"{pre}._depthwise_conv", device, dtype, bias=False)  # (C, 1, k, k)
        p["bn1"] = _bn(sd, f"{pre}._bn1", device, dtype)
        p["se_reduce"] = _conv(sd, f"{pre}._se_reduce", device, dtype)
        p["se_expand"] = _conv(sd, f"{pre}._se_expand", device, dtype)
        p["project_conv"] = _conv(sd, f"{pre}._project_conv", device, dtype)
        p["bn2"] = _bn(sd, f"{pre}._bn2", device, dtype)
        blocks.append(p)
    params["blocks"] = blocks
    params["decoder"] = [{"conv1": _conv(sd, f"decoder.blocks.{i}.conv1.0", device, dtype),
                          "bn1": _bn(sd, f"decoder.blocks.{i}.conv1.1", device, dtype),
                          "conv2": _conv(sd, f"decoder.blocks.{i}.conv2.0", device, dtype),
                          "bn2": _bn(sd, f"decoder.blocks.{i}.conv2.1", device, dtype)} for i in range(5)]
    params["head"] = _conv(sd, "segmentation_head.0", device, dtype)
    return params


def convert_mlp_head(sd: dict, linear_indices: list[int], prefix: str = "model", device="cpu",
                     dtype=None) -> dict:
    """A Sequential MLP (the classifiers, the gaze estimators): the linear
    layers at ``linear_indices`` -> ``{"fc0": ..., "fc1": ...}``."""
    return {f"fc{j}": _linear(sd, f"{prefix}.{i}", device, dtype) for j, i in enumerate(linear_indices)}


def convert_classifier1(sd: dict, device="cpu", dtype=None) -> dict:
    return convert_mlp_head(sd, [2, 5, 8], device=device, dtype=dtype)  # reference classifiers.py:15-25


def convert_classifier2(sd: dict, device="cpu", dtype=None) -> dict:
    return convert_mlp_head(sd, [0, 3, 6], device=device, dtype=dtype)  # classifiers.py:51-59


def convert_gaze_estimator(sd: dict, device="cpu", dtype=None) -> dict:
    return convert_mlp_head(sd, [0, 3, 6], device=device, dtype=dtype)  # gaze_estimators.py:24-32,196-204
