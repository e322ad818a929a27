"""Nothing under benchmark/ imports JAX, Flax or the JAX package, with the
top-level module name compared whole (the port's name begins with the JAX
package's); the reference imports nothing of the port."""

import ast
import os
import subprocess
import sys

from benchmark import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "iris_style_transfer_tpu"}
PORT = "iris_style_transfer_tpu_torch"


def _imports(path: str) -> set[str]:
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module" and node.args:
            if isinstance(node.args[0], ast.Constant):
                names.add(str(node.args[0].value).split(".")[0])
    return names


def _sources(sub: str = ""):
    base = os.path.join(harness.BENCH_DIR, sub)
    for d, _, files in os.walk(base):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_jax_anywhere_in_the_benchmark():
    for path in _sources():
        if os.sep + "tests" + os.sep in path:
            continue
        assert not _imports(path) & FORBIDDEN, path


def test_reference_imports_nothing_of_the_port():
    for path in _sources("reference"):
        assert PORT not in _imports(path), path


def test_what_a_run_loads_holds_no_jax():
    """Every module a run imports, loaded in a fresh process, and the
    harness's own look at sys.modules."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from benchmark import harness, trace, control, checks, taps\n"
        "import benchmark.run\n"
        "for name in ('ist2019-bs64', 'ist2020-bs128-nst20'):\n"
        "    run = harness.Run(harness.Cell.load(name), 1, 1, None)\n"
        "    harness.make_entry(run)\n"
        "import iris_style_transfer_tpu_torch.workloads.ist_openeds2019, iris_style_transfer_tpu_torch.workloads.ist_openeds2020\n"
        "from iris_style_transfer_tpu_torch.models import RITnet, EfficientNet\n"
        "import iris_style_transfer_tpu_torch.transfer.nst\n"
        "print(harness.forbidden_modules())\n" % harness.ROOT
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True,
                         env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert out.stdout.strip().splitlines()[-1] == "[]", out.stdout


def test_the_check_compares_top_level_names_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "iris_style_transfer_tpu_torchx", sys)
    assert "iris_style_transfer_tpu_torchx" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "iris_style_transfer_tpu.models", sys)
    assert "iris_style_transfer_tpu.models" in harness.forbidden_modules()
