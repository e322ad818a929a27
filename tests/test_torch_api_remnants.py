"""Small public names of the JAX package that the port adds late, on the
CPU: ``ops/image.py:resize_bilinear`` (held to JAX, 1e-6: float32
filters summed in another order), ``runtime/profiler.py:trace``,
``runtime/checkpoint.py:restore_checkpoint_file`` (held to JAX, exact) and
``data/native_loader.py:available``."""

import glob
import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from iris_style_transfer_tpu.ops import image as jimg
from iris_style_transfer_tpu.runtime import checkpoint as jckpt

from iris_style_transfer_tpu_torch.data import native_loader
from iris_style_transfer_tpu_torch.ops import image as timg
from iris_style_transfer_tpu_torch.runtime import checkpoint as tckpt
from iris_style_transfer_tpu_torch.runtime.profiler import trace
from iris_style_transfer_tpu_torch.utils import png


@pytest.mark.parametrize("antialias", [True, False])
def test_resize_bilinear_matches_jax(antialias):
    x = np.random.default_rng(0).random((2, 3, 40, 64, 3)).astype(np.float32)
    for size in ((20, 32), (13, 50), (80, 100), (40, 64)):
        got = timg.resize_bilinear(torch.from_numpy(x), size, antialias)
        want = np.asarray(jimg.resize_bilinear(jnp.asarray(x), size, antialias))
        assert got.shape == want.shape and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


def test_trace_writes_a_chrome_trace_and_none_does_nothing(tmp_path):
    with trace(None):
        torch.ones(4).sum()
    out = tmp_path / "trace"
    with trace(str(out)):
        torch.matmul(torch.ones(8, 8), torch.ones(8, 8))
    files = glob.glob(str(out / "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("matmul" in e.get("name", "") for e in events)


def test_restore_checkpoint_file_matches_jax(tmp_path):
    state = {"params": {"fc0": {"w": torch.arange(6.0).reshape(2, 3), "b": torch.ones(2)}}, "step": 7}
    path = tckpt.save_checkpoint(str(tmp_path), 12, state)
    other = str(tmp_path / "heads.npz")
    tckpt.save_checkpoint(str(tmp_path / "x"), 3, state)
    np.savez(other, **dict(np.load(str(tmp_path / "x" / "step_00000003.npz"))))
    for p, step in ((path, 12), (other, 0)):
        got_step, got = tckpt.restore_checkpoint_file(p)
        want_step, want = jckpt.restore_checkpoint_file(p)
        assert got_step == want_step == step
        np.testing.assert_array_equal(got["params"]["fc0"]["w"], want["params"]["fc0"]["w"])
        np.testing.assert_array_equal(got["params"]["fc0"]["w"], np.arange(6.0).reshape(2, 3).T)  # JAX layout
        assert int(got["step"]) == int(want["step"]) == 7


def test_native_loader_available_says_whether_the_helper_builds(monkeypatch):
    assert native_loader.available() is True  # this machine has a C++ compiler (the decode tests need it)

    def no_compiler():
        raise RuntimeError("no C++ compiler")

    monkeypatch.setattr(png, "_lib", no_compiler)
    assert native_loader.available() is False
