"""The port's two IST mains on two ranks (``--n_devices 2``) on the CPU.

As ``tests/test_torch_parallel_mains.py`` runs the trainers: each main
spawns its own two gloo ranks (joined with a timeout) and reads a fake
OpenEDS tree at 48x64; every run must give the JAX mains' metric keys
(``tests/test_workloads.py``), write one set of artifacts (rank 0's) and
match the one-rank run: the pre-NST metrics within 1e-5, the NST losses
rtol 1e-3 and the post-NST metrics within 1e-2, as
``tests/test_torch_slice.py`` holds L-BFGS trajectories that part by
float32 sums in another order.  The 2020 main's tests are in the slow
tier (B7 in three processes).

With ``--model_parallel 2`` each main runs on the two ranks of one model
group, each rank doing the NST on its slab of 112 of the irises' 224 rows
(spatial sharding).  Those ranks are formed by ``run_ranks`` and the main
runs inside their group (as under ``torchrun``), so that each rank can
capture its NST calls' loss histories; they must match one process's: the
pre-NST metrics exactly (each rank runs the whole batch before the NST,
on one thread, as the reference process is made to),
the losses of the first :data:`AGREEING_CLOSURES` closures to rtol 1e-5,
and the post-NST metrics as above.
"""

from __future__ import annotations

import functools
import importlib
import os

import numpy as np
import pytest
import torch

from iris_style_transfer_tpu_torch.data import fake_openeds
from iris_style_transfer_tpu_torch.parallel import run_ranks
from iris_style_transfer_tpu_torch.workloads import ist_openeds2019, ist_openeds2020

from test_torch_parallel_mains import JOIN_S, H, W, _run, bounded_ranks  # noqa: F401  (bounded_ranks: autouse)

AGREEING_CLOSURES = 3


def _ist_close(got: dict, want: dict) -> None:
    assert got.keys() == want.keys()
    for k, v in want.items():
        if k.endswith(("per_min", "per_sec")):
            continue
        if "/pre/" in k or "pre/mean" in k:
            np.testing.assert_allclose(got[k], v, atol=1e-5, rtol=0, err_msg=k)
        elif k.endswith("_loss"):
            np.testing.assert_allclose(got[k], v, rtol=1e-3, atol=1e-10, err_msg=k)
        else:
            np.testing.assert_allclose(got[k], v, atol=1e-2, rtol=0, err_msg=k)


def test_ist_openeds2019_main_on_two_ranks_matches_one_rank(tmp_path, monkeypatch):
    fake_openeds.write_openeds2019(str(tmp_path / "data"), users=(2, 1, 1), frames_per_user=8, height=H, width=W)
    argv = ["-bs", "4", "--nst_epochs", "2", "--data_dir", str(tmp_path / "data"), "--compute_dtype", "float32"]
    want, _, _ = _run(tmp_path, monkeypatch, "one", ist_openeds2019.main, argv)
    got, logs, _ = _run(tmp_path, monkeypatch, "two", ist_openeds2019.main, [*argv, "--n_devices", "2"])
    log, want_log = got[("test/", 1.0, 2)], want[("test/", 1.0, 2)]
    for key in ("test/pre/c1/accu", "test/pre/c2/mis/f1", "test/post/c1/loss", "test/post/c2/mis/auc",
                "test/post/mean_miou", "test/post/mean_iou2", "test//c_loss", "test//s_loss",
                "test/stylized_images_per_min"):
        assert key in log, key
    _ist_close(log, want_log)
    out, out1 = (tmp_path / d / "saved" / "openeds2019" / "sw_1.0_epoch_2" / "test" for d in ("two", "one"))
    assert len(logs) == 1 and sorted(os.listdir(out)) == sorted(os.listdir(out1))
    np.testing.assert_array_equal(np.load(out / "mious_pre.npy"), np.load(out1 / "mious_pre.npy"))
    np.testing.assert_allclose(np.load(out / "mious_post.npy"), np.load(out1 / "mious_post.npy"), atol=1e-2)
    monkeypatch.chdir(tmp_path / "two")
    assert ist_openeds2019.main([*argv, "--n_devices", "2", "--device", "cpu"]) == {}  # rank 0's done.json


@pytest.mark.slow  # B7 in three processes: ~40 s alone, over four minutes under the tier-1 suite's load
def test_ist_openeds2020_main_on_two_ranks_matches_one_rank(tmp_path, monkeypatch):
    fake_openeds.write_openeds2020(str(tmp_path / "data"), sequences=(0, 1, 1), frames_per_sequence=3,
                                   height=H, width=W, seed=3)
    argv = ["-bs", "4", "--nst_epochs", "2", "--data_dir", str(tmp_path / "data"), "--compute_dtype", "float32"]
    want, _, _ = _run(tmp_path, monkeypatch, "one", ist_openeds2020.main, argv)
    got, logs, _ = _run(tmp_path, monkeypatch, "two", ist_openeds2020.main, [*argv, "--n_devices", "2"])
    log, want_log = got[("validation/", 1.0, 2)], want[("validation/", 1.0, 2)]
    for key in ("validation//pre/radian_distance1", "validation//pre/degree_distance2",
                "validation//post/radian_distance2", "validation//post/degree_distance1",
                "validation//c_loss", "validation//s_loss", "validation//stylized_images_per_min"):
        assert key in log, key
    _ist_close(log, want_log)
    out, out1 = (tmp_path / d / "saved" / "openeds2020" / "sw_1.0_epoch_2" / "validation" for d in ("two", "one"))
    assert len(logs) == 1 and sorted(os.listdir(out)) == sorted(os.listdir(out1))
    for name in ("preds1_pre.npy", "preds2_pre.npy", "labels.npy", "gts.npy"):
        np.testing.assert_allclose(np.load(out / name), np.load(out1 / name), atol=1e-5, err_msg=name)
    for name in ("preds1_post.npy", "preds2_post.npy"):
        np.testing.assert_allclose(np.load(out / name), np.load(out1 / name), atol=1e-2, err_msg=name)


# ---------------------------------------------------------------------------
# --model_parallel 2: each NST image's H split over a model group of two
# ---------------------------------------------------------------------------


def _capturing_main(module: str, argv: list[str]):
    """``main(argv)`` of ``workloads.<module>`` on the CPU, with every NST
    call's (c_loss_hist, s_loss_hist) captured; returns (result, hists)."""
    wl = importlib.import_module(f"iris_style_transfer_tpu_torch.workloads.{module}")
    real, hists = wl.cached_nst_program, []

    def capturing(*args):
        fn = real(*args)

        def run(*a, **kw):
            res = fn(*a, **kw)
            hists.append((res.c_loss_hist.clone(), res.s_loss_hist.clone()))
            return res

        return run

    wl.cached_nst_program = capturing
    try:
        return wl.main([*argv, "--device", "cpu"]), hists
    finally:
        wl.cached_nst_program = real


def _spatial_matches_one_rank(tmp_path, monkeypatch, module: str, argv: list[str], key: tuple) -> None:
    """The main on (data 1, model 2) against one process, as the module's
    docstring states."""
    for name in ("one", "two"):
        (tmp_path / name).mkdir()
    monkeypatch.chdir(tmp_path / "one")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # as each spawned rank runs, so that the pre-NST programs sum alike
    try:
        want, want_hists = _capturing_main(module, argv)
    finally:
        torch.set_num_threads(threads)
    monkeypatch.chdir(tmp_path / "two")
    got, hists = run_ranks(functools.partial(_capturing_main, module, [*argv, "--n_devices", "2",
                                                                       "--model_parallel", "2"]),
                           2, devices=["cpu", "cpu"], timeout=JOIN_S)
    log, want_log = got[key], want[key]
    for k, v in want_log.items():
        if "/pre/" in k or "pre/mean" in k:
            assert log[k] == v, (k, log[k], v)
    _ist_close(log, want_log)
    assert len(hists) == len(want_hists) > 0
    k = AGREEING_CLOSURES
    for (c, s), (c1, s1) in zip(hists, want_hists):
        np.testing.assert_allclose(s[:k].numpy(), s1[:k].numpy(), rtol=1e-5)
        np.testing.assert_allclose(c[:k].numpy(), c1[:k].numpy(), rtol=1e-5, atol=1e-12)
    assert len(list((tmp_path / "two" / "saved" / "logs").glob("*.jsonl"))) == 1  # rank 0's alone


def test_ist_openeds2019_main_on_a_model_group_matches_one_rank(tmp_path, monkeypatch):
    fake_openeds.write_openeds2019(str(tmp_path / "data"), users=(2, 1, 1), frames_per_user=8, height=H, width=W)
    argv = ["-bs", "4", "--nst_epochs", str(AGREEING_CLOSURES), "--data_dir", str(tmp_path / "data"),
            "--compute_dtype", "float32", "--stats_taps", "on"]
    _spatial_matches_one_rank(tmp_path, monkeypatch, "ist_openeds2019", argv, ("test/", 1.0, AGREEING_CLOSURES))


@pytest.mark.slow  # B7 in three processes, as the data-parallel 2020 test above
def test_ist_openeds2020_main_on_a_model_group_matches_one_rank(tmp_path, monkeypatch):
    fake_openeds.write_openeds2020(str(tmp_path / "data"), sequences=(0, 1, 1), frames_per_sequence=3,
                                   height=H, width=W, seed=3)
    argv = ["-bs", "4", "--nst_epochs", str(AGREEING_CLOSURES), "--data_dir", str(tmp_path / "data"),
            "--compute_dtype", "float32"]
    _spatial_matches_one_rank(tmp_path, monkeypatch, "ist_openeds2020", argv,
                              ("validation/", 1.0, AGREEING_CLOSURES))
