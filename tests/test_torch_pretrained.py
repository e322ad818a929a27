"""The port's ``load_pretrained`` checks an auto-discovered npz against the
manifest as the JAX package does (``tests/test_pretrained_manifest.py``),
and never writes the manifest.

Each test points both packages at a temporary weights directory and a
temporary manifest, so nothing touches the real auto-discovery path or
``tools/weights_manifest.json``.
"""

import hashlib
import json
import os

import numpy as np
import pytest
import torch

from iris_style_transfer_tpu.models import pretrained as jpre

from iris_style_transfer_tpu_torch.models import load_pretrained
from iris_style_transfer_tpu_torch.models import pretrained as tpre


@pytest.fixture()
def weights_env(tmp_path, monkeypatch):
    """A vgg19 npz in a temporary weights directory, and a manifest whose
    vgg19 entry has no checksum yet; both packages read them."""
    wdir = tmp_path / "weights"
    wdir.mkdir()
    npz = str(wdir / "vgg19.npz")
    w = np.arange(12, dtype=np.float32).reshape(1, 1, 3, 4)
    np.savez(npz, **{"conv1_1/w": w, "conv1_1/b": np.zeros(4, np.float32)})
    manifest = tmp_path / "manifest.json"
    manifest.write_text(json.dumps({"artifacts": [{"kind": "vgg19", "out": "weights/vgg19.npz"}]}))
    for mod in (tpre, jpre):
        monkeypatch.setattr(mod, "WEIGHTS_DIR", str(wdir))
        monkeypatch.setattr(mod, "MANIFEST_PATH", str(manifest))
    return npz, manifest, w


def _record(manifest, sha):
    data = json.loads(manifest.read_text())
    data["artifacts"][0]["npz_sha256"] = sha
    manifest.write_text(json.dumps(data))


def test_missing_checksum_passes(weights_env):
    npz, _, w = weights_env
    params = load_pretrained("vgg19")
    assert params["conv1_1"]["w"].shape == (4, 3, 1, 1)  # HWIO -> OIHW
    torch.testing.assert_close(params["conv1_1"]["w"], torch.from_numpy(w).permute(3, 2, 0, 1))


def test_matching_checksum_loads(weights_env):
    npz, manifest, _ = weights_env
    _record(manifest, hashlib.sha256(open(npz, "rb").read()).hexdigest())
    assert set(load_pretrained("vgg19")["conv1_1"]) == {"w", "b"}


def test_mismatch_raises_the_jax_message(weights_env):
    npz, manifest, _ = weights_env
    _record(manifest, "0" * 64)
    with pytest.raises(ValueError) as port_err:
        load_pretrained("vgg19", init_fn=lambda: "seeded")
    with pytest.raises(ValueError) as jax_err:
        jpre.load_pretrained("vgg19")
    assert "manifest checksum" in str(port_err.value)
    assert str(port_err.value) == str(jax_err.value)


def test_explicit_path_bypasses_and_manifest_is_never_written(weights_env, tmp_path):
    npz, manifest, _ = weights_env
    _record(manifest, "0" * 64)
    before = (manifest.read_bytes(), os.stat(manifest).st_mtime_ns)
    other = str(tmp_path / "custom.npz")
    np.savez(other, **{"conv1_1/w": np.ones((1, 1, 3, 4), np.float32), "conv1_1/b": np.zeros(4, np.float32)})
    assert float(load_pretrained("vgg19", explicit_path=other)["conv1_1"]["w"].sum()) == 12.0
    with pytest.raises(ValueError, match="manifest checksum"):
        load_pretrained("vgg19")
    assert (manifest.read_bytes(), os.stat(manifest).st_mtime_ns) == before
    assert not [n for n in dir(tpre) if "record" in n]  # the port has no manifest writer
