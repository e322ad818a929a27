"""The port's two IST mains on two ranks (``--n_devices 2``) on the CPU.

As ``tests/test_torch_parallel_mains.py`` runs the trainers: each main
spawns its own two gloo ranks (joined with a timeout) and reads a fake
OpenEDS tree at 48x64; every run must give the JAX mains' metric keys
(``tests/test_workloads.py``), write one set of artifacts (rank 0's) and
match the one-rank run: the pre-NST metrics within 1e-5, the NST losses
rtol 1e-3 and the post-NST metrics within 1e-2, as
``tests/test_torch_slice.py`` holds L-BFGS trajectories that part by
float32 sums in another order.  The 2020 main's test is in the slow
tier (B7 in three processes).
"""

from __future__ import annotations

import os

import numpy as np
import pytest

from iris_style_transfer_tpu_torch.data import fake_openeds
from iris_style_transfer_tpu_torch.workloads import ist_openeds2019, ist_openeds2020

from test_torch_parallel_mains import H, W, _run, bounded_ranks  # noqa: F401  (bounded_ranks: an autouse fixture)


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
