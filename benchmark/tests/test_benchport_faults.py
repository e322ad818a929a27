"""The check against a broken timed path, and the control, at a tiny size
on the CPU: a sound run is correct, and each fault the 2019 cell can have
turns ``correct`` false under the cell's own limits.  (One card: no
exchange between chips to leave out.)  The control, the reference one
precision lower in the program's place, is not correct either."""

import importlib
import time

import pytest
import torch

from benchmark import harness
from benchmark.reference.precision import CONTROL

SEED = 2**31 + 7


def _run():
    torch.set_num_threads(min(8, torch.get_num_threads()))
    return harness.execute(_tiny("ist2019-bs64"), SEED, 1, False, time.perf_counter(), device="cpu")


def _failed(result) -> list[str]:
    return [k for k, c in result["checks"].items() if not c["value"] <= c["limit"]]


@pytest.fixture(scope="module")
def nst_module():
    return importlib.import_module("iris_style_transfer_tpu_torch.transfer.nst")


def test_sound_run_is_correct():
    result = _run()
    assert result["correct"], _failed(result)


def test_a_step_that_leaves_the_state_unchanged(monkeypatch, nst_module):
    real = nst_module.lbfgs_step

    def frozen(state, g, lr=1.0, method="compact", group=None):
        update, new = real(state, g, lr, method=method, group=group)
        return torch.zeros_like(update), new

    monkeypatch.setattr(nst_module, "lbfgs_step", frozen)
    result = _run()
    assert not result["correct"] and "lbfgs_first_step_gap" in _failed(result)


def test_half_the_batch_left_out(monkeypatch, nst_module):
    """The NST's losses over the first half of the batch only (the mean
    over the rest): the other half's images do not move."""
    stats, content = nst_module.style_stats, nst_module.content_loss_l2
    monkeypatch.setattr(nst_module, "style_stats", lambda f: stats(f[: max(1, f.shape[0] // 2)]))
    monkeypatch.setattr(nst_module, "content_loss_l2",
                        lambda p, t: content([x[: max(1, x.shape[0] // 2)] for x in p],
                                             [x[: max(1, x.shape[0] // 2)] for x in t]))
    result = _run()
    assert not result["correct"] and "nst_grad_gap" in _failed(result)


UPDATE = "            x = x + update\n"


@pytest.fixture
def planted_loop(nst_module):
    """The NST module run again from its own source with the loop's line
    ``x = x + update`` replaced, and each main's ``cached_nst_program``
    pointed at the planted one; the module as it was afterwards."""
    main = importlib.import_module("iris_style_transfer_tpu_torch.workloads.ist_openeds2019")
    with open(nst_module.__file__) as f:
        source = f.read()
    assert source.count(UPDATE) == 1
    saved, real = dict(nst_module.__dict__), main.cached_nst_program

    def plant(line: str) -> None:
        exec(compile(source.replace(UPDATE, line), nst_module.__file__, "exec"), nst_module.__dict__)
        main.cached_nst_program = nst_module.cached_nst_program

    yield plant
    nst_module.__dict__.clear()
    nst_module.__dict__.update(saved)
    main.cached_nst_program = real


@pytest.mark.parametrize("line", [
    "            x = x\n",  # the steps are sound, the image never moves
    "            h = max(1, x.shape[0] // 2)\n"
    "            x = torch.cat([x[:h] + update[:h], x[h:]])\n",  # only the first half moves
], ids=["image_left_unchanged", "half_the_batch_updated"])
def test_the_loop_update_planted(planted_loop, line):
    planted_loop(line)
    result = _run()
    assert not result["correct"] and "nst_image_mismatch" in _failed(result)


def test_an_answer_altered_where_it_is_produced(monkeypatch):
    classifiers = importlib.import_module("iris_style_transfer_tpu_torch.models.classifiers")
    real = classifiers.Classifier1.apply

    def altered(params, feats, *a, **kw):
        out = real(params, feats, *a, **kw).clone()
        out[0, 0] += out.abs().max()
        return out

    monkeypatch.setattr(classifiers.Classifier1, "apply", staticmethod(altered))
    result = _run()
    assert not result["correct"] and {"pre_logit_gap", "post_logit_gap"} <= set(_failed(result))


def _tiny(name: str):
    cell = harness.Cell.load(name)
    cell.traffic.update(batch_size=2, warm_closures=1)
    if name.startswith("ist2020"):
        cell.traffic.update(frame_height=112, frame_width=160)
    cell.config.update(nst_epochs=4)
    return cell


@pytest.mark.parametrize("name", ["ist2019-bs64", "ist2020-bs128-nst20"])
def test_the_control_is_not_correct(name):
    """The reference one precision lower in the program's place fails the
    cell's limits; the program on the same inputs passes them."""
    torch.set_num_threads(min(8, torch.get_num_threads()))
    cell = _tiny(name)
    run = harness.Run(cell, SEED, 1, torch.device("cpu"))
    entry = run.entry = harness.make_entry(run)
    entry.setup()
    run.timed = entry.timed_pass()
    entry.release()
    program = harness.checks(cell, entry.judge())
    control = harness.checks(cell, entry.judge(entry.control_outputs(CONTROL)))
    assert all(v <= lim for _, v, lim in program), program
    assert any(not v <= lim for _, v, lim in control), control
