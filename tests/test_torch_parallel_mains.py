"""The port's two trainers on two ranks (``--n_devices 2``) on the CPU.

Each main spawns its own two gloo ranks (``runtime/config.py:run_on_ranks``,
joined here with a timeout of :data:`JOIN_S`), or ``torchrun`` starts them;
the classifier trainer reads a fake OpenEDS2019 tree at 48x64
(``data/fake_openeds.py``), which the spawned ranks see as the parent does;
the gaze trainer runs on its synthetic twin.  Every run must give the JAX
mains' metric keys (``tests/test_workloads.py``), write one set of
artifacts (rank 0's) and match the one-rank run:

  * the classifier trainer, its batch or its heads split: every metric
    but the step rate within 1e-5 (the gradient of the batch mean is the
    mean of the two halves', and the split heads sum fc1 in another order;
    Adam at lr 1e-5 moves the logits far less than that);
  * the gaze trainer (estimator 1), also resumed on two ranks from one
    rank's checkpoints: within 1e-4 (the same, at lr up to 1e-4).

The IST mains are in ``tests/test_torch_parallel_ist.py``.
"""

from __future__ import annotations

import functools
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from iris_style_transfer_tpu_torch.data import fake_openeds
from iris_style_transfer_tpu_torch.parallel import run_ranks
from iris_style_transfer_tpu_torch.runtime import config
from iris_style_transfer_tpu_torch.workloads import gaze_estimation, ist_openeds2019, ist_openeds2020
from iris_style_transfer_tpu_torch.workloads import iris_classification

H, W = 48, 64
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


JOIN_S = 120  # every spawned run fails after this many seconds


@pytest.fixture(autouse=True)
def bounded_ranks(monkeypatch):
    """The mains spawn their ranks through ``run_on_ranks``; here each such
    run is joined with a timeout, after which its ranks are killed."""
    monkeypatch.setattr(config, "run_ranks", functools.partial(run_ranks, timeout=JOIN_S))


def _run(tmp_path, monkeypatch, name: str, main, argv):
    """``main(argv)`` in its own directory; returns (result, its log files,
    their metric records)."""
    run_dir = tmp_path / name
    run_dir.mkdir()
    monkeypatch.chdir(run_dir)
    result = main([*argv, "--device", "cpu"])
    logs = list((run_dir / "saved" / "logs").glob("*.jsonl"))
    records = [json.loads(line) for f in logs for line in f.read_text().splitlines()]
    return result, logs, [{k: v for k, v in r.items() if not k.startswith("_")} for r in records if "_config" not in r]


def _close(got: dict, want: dict, atol: float, skip=("steps_per_sec", "images_per_min")):
    assert got.keys() == want.keys()
    for k, v in want.items():
        if not k.endswith(skip):
            np.testing.assert_allclose(got[k], v, atol=atol, rtol=0, err_msg=k)


# ---------------------------------------------------------------------------
# the classifier trainer: data-parallel, tensor-parallel, resumed elsewhere
# ---------------------------------------------------------------------------

CLS_KEYS = ("train/c1/accu", "train/c2/loss", "test/c1/f1", "test/c2/mcc", "test/c1/auc", "train/steps_per_sec")


@pytest.fixture(scope="module")
def cls_tree(tmp_path_factory):
    data = tmp_path_factory.mktemp("cls") / "data"
    fake_openeds.write_openeds2019(str(data), users=(2, 1, 1), frames_per_user=8, height=H, width=W)
    return ["-bs", "8", "--data_dir", str(data), "--compute_dtype", "float32"]


@pytest.fixture(scope="module")
def cls_one_rank(cls_tree, tmp_path_factory):
    """One epoch on one rank (no checkpoint: the heads' is 1.6 GB; the
    split checkpoint is held in ``tests/test_torch_parallel.py``)."""
    mp = pytest.MonkeyPatch()
    try:
        return _run(tmp_path_factory.mktemp("one"), mp, "run", iris_classification.main,
                    [*cls_tree, "-E", "1", "-SP", "-1"])[0]
    finally:
        mp.undo()


@pytest.mark.parametrize("split", [["--n_devices", "2"], ["--n_devices", "2", "--model_parallel", "2"]],
                         ids=["data", "data_and_model"])
def test_classification_main_on_two_ranks_matches_one_rank(cls_tree, cls_one_rank, tmp_path, monkeypatch, split):
    """The batch split over two ranks, or the heads split over them
    (``--model_parallel 2``: fc0 column- and fc1 row-parallel)."""
    result, logs, got = _run(tmp_path, monkeypatch, "two", iris_classification.main,
                             [*cls_tree, "-E", "1", "-SP", "-1", *split])
    for key in CLS_KEYS:
        assert key in result and np.isfinite(result[key]), key
    assert len(logs) == 1 and len(got) == 1  # rank 0's log alone
    _close(result, cls_one_rank, 1e-5)


def test_mains_refuse_a_mesh_they_cannot_form(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit, match="torchrun"):
        iris_classification.main(["--device", "cpu", "--model_parallel", "2"])
    for main in (ist_openeds2019.main, ist_openeds2020.main):
        # one process cannot form a model group of two; a model group of
        # three cannot split the relu4_1 tap's 28 rows (JAX's message)
        with pytest.raises(SystemExit, match="1 rank is not divisible by model_parallel=2"):
            main(["--device", "cpu", "--model_parallel", "2"])
        with pytest.raises(SystemExit, match=r"model_parallel=3 must divide the relu4_1 tap height 224/8=28 "
                                             r"\(use 2, 4, 7, 14 or 28\)"):
            main(["--device", "cpu", "--model_parallel", "3", "--n_devices", "3"])


# ---------------------------------------------------------------------------
# the gaze trainer
# ---------------------------------------------------------------------------


def test_gaze_main_on_two_ranks_matches_one_rank_and_resumes_across(tmp_path, monkeypatch):
    """Two ranks match one; then two ranks resume from one rank's epoch-1
    checkpoints to the one-rank run's second epoch."""
    argv = ["-estimator", "1", "-bs", "32", "--data_dir", str(tmp_path / "nodata")]
    want, _, _ = _run(tmp_path, monkeypatch, "one", gaze_estimation.main, [*argv, "-E", "1", "-SP", "1"])
    got, logs, records = _run(tmp_path, monkeypatch, "two", gaze_estimation.main,
                              [*argv, "-E", "1", "-SP", "1", "--n_devices", "2"])
    for key in ("train/loss", "train/radian_distance", "train/degree_distance", "valid/loss",
                "valid/degree_distance", "train/steps_per_sec"):
        assert key in got and np.isfinite(got[key]), key
    assert len(logs) == 3 and len(records) == 3  # one log per learning rate, rank 0's
    assert len(list((tmp_path / "two" / "saved" / "checkpoints").glob("*/state_00000001.npz"))) == 3
    _close(got, want, 1e-4)

    want2, _, _ = _run(tmp_path, monkeypatch, "straight", gaze_estimation.main, [*argv, "-E", "2", "-SP", "-1"])
    monkeypatch.chdir(tmp_path / "one")
    resumed = gaze_estimation.main([*argv, "-E", "2", "-SP", "-1", "--resume", "--n_devices", "2", "--device", "cpu"])
    _close(resumed, want2, 1e-4)


def test_gaze_main_under_torchrun(tmp_path, monkeypatch):
    """``torchrun --standalone --nproc_per_node 2``: the launcher's
    environment says the ranks, and the main forms its mesh from it."""
    argv = ["-estimator", "1", "-bs", "32", "-E", "1", "-SP", "-1", "--data_dir", str(tmp_path / "nodata"),
            "--device", "cpu"]
    code = ("import json, sys, torch.distributed as dist\n"
            "from iris_style_transfer_tpu_torch.workloads import gaze_estimation\n"
            "log = gaze_estimation.main(sys.argv[1:])\n"
            "if dist.get_rank() == 0:\n"
            "    print('LOG', json.dumps(log))\n")
    (tmp_path / "run.py").write_text(code)
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([REPO, os.environ.get("PYTHONPATH", "")])}
    out = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2",
                          str(tmp_path / "run.py"), *argv], cwd=tmp_path, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(next(line[4:] for line in out.stdout.splitlines() if line.startswith("LOG ")))
    logs = list((tmp_path / "saved" / "logs").glob("*.jsonl"))
    assert len(logs) == 3 and all(len(f.read_text().splitlines()) == 2 for f in logs)  # rank 0's, one epoch each
    want, _, _ = _run(tmp_path, monkeypatch, "one", gaze_estimation.main, argv[:-2])
    _close(got, want, 1e-4)
