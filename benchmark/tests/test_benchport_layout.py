"""The harness is driven by data: a cell added as files in a copy is found
without an edit; a run without a card fails and prints no result."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark import harness


def test_a_new_cell_file_is_found_without_edits(tmp_path):
    shutil.copytree(harness.BENCH_DIR, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    spec = json.loads((tmp_path / "benchmark" / "cells" / "ist2019-bs64.json").read_text())
    (tmp_path / "benchmark" / "traffic" / "sweep-bs32.json").write_text(json.dumps(
        {"name": "sweep-bs32", "batch_size": 32, "frame_height": 400, "frame_width": 640, "warm_closures": 4}))
    spec["traffic"] = "sweep-bs32"
    (tmp_path / "benchmark" / "cells" / "ist2019-bs32.json").write_text(json.dumps(spec))
    bench["workloads"].append({"name": "ist2019-bs32", "config": "vgg19-ist2019", "traffic": "sweep-bs32",
                               "chips": 1, "why": "a test cell"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from benchmark import harness\n"
        "assert harness.ROOT == %r, harness.ROOT\n"
        "cell = harness.Cell.load('ist2019-bs32')\n"
        "entry = harness.make_entry(harness.Run(cell, 1, 1, None))\n"
        "print(cell.traffic['batch_size'], entry.bs, len(cell.metrics('per_layer')))\n" % (str(tmp_path), str(tmp_path))
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True)
    want = len([m for m in bench["per_layer"] if "workloads" not in m])
    assert out.stdout.split() == ["32", "32", str(want)]


def test_run_without_a_card_fails_and_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    out = subprocess.run([sys.executable, os.path.join(harness.BENCH_DIR, "run.py"), "--workload", "ist2019-bs64",
                          "--seed", "2147483649", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=harness.ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "cuda" in out.stderr.lower()
