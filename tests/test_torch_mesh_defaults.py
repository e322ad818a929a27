"""How many ranks a main of the port runs on, and the gaze main's
``--model_parallel``, against the JAX mains' rules, on the CPU.

  * ``--n_devices 0``, the default, means every device in JAX
    (``iris_style_transfer_tpu/runtime/config.py``, ``parallel/mesh.py:
    make_mesh``).  In the port a CUDA device outside a process group then
    spawns one rank per visible card; one card, the CPU, an explicit
    ``--n_devices`` and a run under ``torchrun`` keep one process or the
    count given.  ``torch.cuda.device_count`` and ``run_ranks`` are patched
    here, so no rank is started.
  * The JAX gaze main builds a data-only mesh whatever ``--model_parallel``
    says (``workloads/gaze_estimation.py``); the port's accepts the flag,
    says it has no effect, and its metrics equal those of
    ``--model_parallel 1`` exactly (the same process, the same seeds).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from iris_style_transfer_tpu_torch.runtime import config
from iris_style_transfer_tpu_torch.workloads import gaze_estimation, iris_classification, ist_openeds2019
from iris_style_transfer_tpu_torch.workloads import ist_openeds2020

MAINS = {"ist2019": ist_openeds2019.main, "ist2020": ist_openeds2020.main,
         "classification": iris_classification.main, "gaze": gaze_estimation.main}


@pytest.fixture
def cards(monkeypatch):
    """A host of ``n`` cards (``cards(n)``) with CUDA, whose ``run_ranks``
    records its calls (rank count, devices, the partial's argv) and starts
    nothing."""
    calls = []

    def record(fn, n, devices=None, **kw):
        calls.append((n, devices, fn.args[0]))
        return "spawned"

    def set_cards(n: int):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: n)
        return calls

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    monkeypatch.setattr(config, "run_ranks", record)
    return set_cards


@pytest.mark.parametrize("name", sorted(MAINS))
def test_n_devices_0_on_cuda_spawns_a_rank_per_card(cards, name):
    calls = cards(4)
    argv = ["-bs", "8"]
    assert MAINS[name](argv) == "spawned"  # --device cuda and --n_devices 0 are the defaults
    assert calls == [(4, None, argv)]  # rank r on cuda:r


def _spawns(n_devices: int, device: str):
    cfg = config.WorkloadConfig(n_devices=n_devices)
    return config.spawns_ranks(cfg, torch.device(device)), config._ranks(cfg, torch.device(device))


def test_one_card_the_cpu_explicit_counts_and_torchrun_keep_their_rank_count(cards, monkeypatch):
    cards(1)
    assert _spawns(0, "cuda") == (False, 1)  # one card: one process, no spawn
    cards(4)
    assert _spawns(0, "cpu") == (False, 0)  # the CPU: one process
    assert _spawns(1, "cuda") == (False, 1)
    assert _spawns(2, "cuda") == (True, 2)
    assert _spawns(2, "cpu") == (True, 2)
    calls = cards(4)
    config.run_on_ranks(gaze_estimation.main, ["--n_devices", "2"], config.WorkloadConfig(n_devices=2),
                        torch.device("cpu"))
    assert calls == [(2, [torch.device("cpu")] * 2, ["--n_devices", "2"])]
    monkeypatch.setenv("WORLD_SIZE", "4")  # under torchrun the launcher says the ranks
    assert not config.spawns_ranks(config.WorkloadConfig(), torch.device("cuda"))
    assert not config.spawns_ranks(config.WorkloadConfig(n_devices=4), torch.device("cuda"))


def test_gaze_main_takes_model_parallel_and_runs_data_only(tmp_path, monkeypatch, capsys):
    argv = ["-estimator", "1", "-bs", "32", "-E", "1", "-SP", "-1", "--data_dir", str(tmp_path / "nodata"),
            "--device", "cpu"]
    runs = {}
    for mp in (1, 2):
        run_dir = tmp_path / f"mp{mp}"
        run_dir.mkdir()
        monkeypatch.chdir(run_dir)
        runs[mp] = gaze_estimation.main([*argv, "--model_parallel", str(mp)])
        said = capsys.readouterr().out
        assert ("--model_parallel 2 has no effect on this main" in said) == (mp == 2)
    assert runs[2].keys() == runs[1].keys()
    for k, v in runs[1].items():
        if k != "train/steps_per_sec":
            np.testing.assert_array_equal(runs[2][k], v, err_msg=k)
