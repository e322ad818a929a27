"""The port's weight converters (``models/port.py:convert_*``), ``save_npz``,
the ``tools/port_weights.py`` command line and ``record_npz_checksum``,
against the JAX package's converters, on the CPU.

Each state dict is seeded and built under the source's key names
(torchvision's VGG19, VGG19_BN and ResNet50, smp's Unet(efficientnet-b7)
with a DataParallel ``module.`` prefix, the bundled RITnet's, the
reference's Sequential heads), at the models' full widths, with the
sources' bias-free convs left without a bias key.  Tolerance: exact (the
converters only move and transpose arrays).
"""

import json
import os
import pickle
import shutil

import numpy as np
import pytest
import torch

import jax

from iris_style_transfer_tpu.models import EfficientNet as JB7
from iris_style_transfer_tpu.models import ResNet50 as JResNet50
from iris_style_transfer_tpu.models import RITnet as JRITnet
from iris_style_transfer_tpu.models import VGG19 as JVGG
from iris_style_transfer_tpu.models import port as jport

from iris_style_transfer_tpu_torch.models import port as tport
from iris_style_transfer_tpu_torch.models import pretrained as tpre
from iris_style_transfer_tpu_torch.models.vgg import VGG19_BN_LAYERS, VGG19_LAYERS
from iris_style_transfer_tpu_torch.tools import port_weights

LEAF = {"w": "weight", "b": "bias", "scale": "weight", "bias": "bias", "mean": "running_mean", "var": "running_var"}


def _state_dict(init, key_of, has_bias=lambda parts: True, seed=0) -> dict:
    """A seeded state dict for the JAX param tree ``init`` builds: each
    leaf under ``key_of(path parts)``, in torch's layout (OIHW convs, (out,
    in) linears); conv biases only where ``has_bias(parts)``."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(init, jax.random.PRNGKey(0))
    sd = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        parts = [str(getattr(p, "key", getattr(p, "idx", p))) for p in path]
        s = leaf.shape
        if parts[-1] == "b" and not has_bias(parts):
            continue
        if parts[-1] == "w":
            s = (s[3], s[2], s[0], s[1]) if len(s) == 4 else s[::-1]
        sd[key_of(parts[:-1]) + "." + LEAF[parts[-1]]] = rng.standard_normal(s, dtype=np.float32)
    return sd


def _vgg_key(table):
    def key(parts):
        return f"features.{table[parts[0]]}"

    return key


def _resnet_key(parts):
    return ".".join(parts).replace("downsample.conv", "downsample.0").replace("downsample.bn", "downsample.1")


_B7_NAMES = {"stem_conv": "encoder._conv_stem", "stem_bn": "encoder._bn0", "head": "segmentation_head.0"}


def _b7_key(parts):
    if parts[0] in _B7_NAMES:
        return "module." + _B7_NAMES[parts[0]]
    if parts[0] == "blocks":
        return f"module.encoder._blocks.{parts[1]}._" + parts[2].replace("dw_conv", "depthwise_conv")
    sub = {"conv1": "conv1.0", "bn1": "conv1.1", "conv2": "conv2.0", "bn2": "conv2.1"}[parts[2]]
    return f"module.decoder.blocks.{parts[1]}.{sub}"


def _ritnet_key(parts):
    if parts[0] == "out_conv":
        return "out_conv1"
    return parts[0].replace("down", "down_block").replace("up", "up_block") + "." + ".".join(parts[1:])


def _head_sd(indices, dims, seed):
    rng = np.random.default_rng(seed)
    sd = {}
    for i, (din, dout) in zip(indices, dims):
        sd[f"model.{i}.weight"] = rng.standard_normal((dout, din), dtype=np.float32)
        sd[f"model.{i}.bias"] = rng.standard_normal(dout, dtype=np.float32)
    return sd


CASES = {
    "vgg19": (lambda: _state_dict(JVGG.init, _vgg_key(VGG19_LAYERS)), {}),
    "vgg19_bn": (lambda: _state_dict(lambda k: JVGG.init(k, bn=True), _vgg_key(VGG19_BN_LAYERS)), {"bn": True}),
    "resnet50": (lambda: _state_dict(JResNet50.init, _resnet_key, lambda parts: False), {}),
    "efficientnet_unet": (lambda: _state_dict(JB7.init, _b7_key,
                                              lambda parts: parts[0] == "head" or parts[-2].startswith("se_")), {}),
    "ritnet": (lambda: _state_dict(JRITnet.init, _ritnet_key), {}),
    "classifier1": (lambda: _head_sd([2, 5, 8], [(300, 40), (40, 40), (40, 8)], 1), {}),
    "classifier2": (lambda: _head_sd([0, 3, 6], [(1920, 32), (32, 32), (32, 8)], 2), {}),
    "gaze": (lambda: _head_sd([0, 3, 6], [(19, 64), (64, 64), (64, 3)], 3), {}),
}
CONVERTER = {"vgg19_bn": "convert_vgg19", "gaze": "convert_gaze_estimator", "efficientnet_unet": "convert_efficientnet_unet"}


def _assert_trees_equal(got, want, path=""):
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), path
        for k in want:
            _assert_trees_equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_trees_equal(g, w, f"{path}/{i}")
    else:
        assert got.dtype == want.dtype and got.shape == want.shape, path
        assert got.device == want.device and torch.equal(got, want), path


@pytest.mark.parametrize("kind", list(CASES))
def test_converter_equals_from_jax_of_the_jax_converter(kind):
    make, kw = CASES[kind]
    sd = make()
    name = CONVERTER.get(kind, f"convert_{kind}")
    # the JAX converter expects the ``module.`` prefix already stripped
    jsd = {k.removeprefix("module."): v for k, v in sd.items()}
    want = jax.tree_util.tree_map(np.asarray, getattr(jport, name)(jsd, **kw))
    _assert_trees_equal(getattr(tport, name)(sd, **kw), tport.from_jax(want))
    if kind in ("resnet50", "gaze"):  # tensors in, and an explicit dtype
        tsd = {k: torch.from_numpy(v) for k, v in sd.items()}
        _assert_trees_equal(getattr(tport, name)(tsd, dtype=torch.bfloat16, **kw),
                            tport.from_jax(want, dtype=torch.bfloat16))


def test_save_npz_loads_in_both_packages(tmp_path):
    sd = CASES["resnet50"][0]()
    want = jport.convert_resnet50(sd)
    path = str(tmp_path / "resnet50.npz")
    tport.save_npz(path, tport.convert_resnet50(sd))
    got = jport.load_npz(path)
    flat_got, flat_want = jport.flatten_pytree(got), jport.flatten_pytree(want)
    assert sorted(flat_got) == sorted(flat_want)
    for k in flat_want:
        np.testing.assert_array_equal(flat_got[k], flat_want[k])
        assert flat_got[k].dtype == flat_want[k].dtype
    _assert_trees_equal(tport.from_jax(tport.load_npz(path)), tport.convert_resnet50(sd))


def test_cli_converts_a_saved_checkpoint(tmp_path):
    sd = CASES["vgg19"][0]()
    want = jport.flatten_pytree(jport.convert_vgg19(sd))
    tsd = {k: torch.from_numpy(v) for k, v in sd.items()}
    plain, wrapped = str(tmp_path / "vgg19.pth"), str(tmp_path / "wrapped.pth")
    torch.save(tsd, plain)
    torch.save({"state_dict": {"module." + k: v for k, v in tsd.items()}, "epoch": 3}, wrapped)
    for src in (plain, wrapped):
        dst = str(tmp_path / "out.npz")
        port_weights.main(["vgg19", src, dst])
        got = jport.flatten_pytree(jport.load_npz(dst))
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    bad = str(tmp_path / "pickled.pth")
    torch.save({"model": shutil.SameFileError("not a tensor")}, bad)
    with pytest.raises(pickle.UnpicklingError, match="weights_only"):
        port_weights.main(["vgg19", bad, str(tmp_path / "never.npz")])
    assert not os.path.exists(tmp_path / "never.npz")


def test_record_npz_checksum_writes_only_the_manifest_it_is_pointed_at(tmp_path, monkeypatch):
    real = tpre.MANIFEST_PATH
    with open(real, "rb") as f:
        real_bytes = f.read()
    manifest = tmp_path / "weights_manifest.json"
    manifest.write_bytes(real_bytes)
    monkeypatch.setattr(tpre, "MANIFEST_PATH", str(manifest))
    npz = tmp_path / "vgg19.npz"
    np.savez(npz, a=np.arange(3))
    tpre.record_npz_checksum("vgg19", str(npz))
    entry = next(a for a in json.loads(manifest.read_text())["artifacts"] if a["kind"] == "vgg19")
    assert entry["npz_sha256"] == tpre._sha256(str(npz))
    tpre.verify_manifest_checksum("vgg19", str(npz))  # the recorded checksum now passes
    with pytest.raises(KeyError, match="no_such_kind"):
        tpre.record_npz_checksum("no_such_kind", str(npz))
    with open(real, "rb") as f:
        assert f.read() == real_bytes
