"""The port's experiment sweep (``iris_style_transfer_tpu_torch/experiments.py``)
against the JAX package's ``experiments.sh``, on the CPU.

``experiments.sh`` is parsed read-only: its ``$PY <module> <flags>``
lines and ``for`` loops expand to the 27 command lines, and the sweep's
``--dry_run`` prints the same lines in the same order, with the port's
module prefix and ``--device``.  Every line's flags parse with the port's
own parser for that main (the ``parse_config`` it calls, which for the IST
mains is ``workloads/sweep.py``'s, is stopped right after the parse, so
nothing runs).
"""

import os
import re
import shlex

import pytest

from iris_style_transfer_tpu_torch import experiments
from iris_style_transfer_tpu_torch.workloads import (gaze_estimation, iris_classification, ist_openeds2019,
                                                     ist_openeds2020, sweep)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAINS = {"iris_classification": iris_classification, "gaze_estimation": gaze_estimation,
         "ist_openeds2019": ist_openeds2019, "ist_openeds2020": ist_openeds2020}
PARSES = {**MAINS, "ist_openeds2019": sweep, "ist_openeds2020": sweep}  # the module whose parse_config a main calls


def _sh_lines() -> list[str]:
    """experiments.sh's command lines, its loops expanded."""
    lines, loop = [], None
    with open(os.path.join(REPO, "experiments.sh")) as fh:
        for raw in fh:
            line = raw.strip()
            m = re.match(r"for (\w+) in (.*); do$", line)
            if m:
                loop = (m.group(1), m.group(2).split())
            elif line == "done":
                loop = None
            elif line.startswith("$PY "):
                cmd = "python -m " + line[len("$PY "):]
                if loop:
                    lines += [cmd.replace(f"${loop[0]}", v) for v in loop[1]]
                else:
                    lines.append(cmd)
    return lines


def test_dry_run_prints_experiments_sh_lines(capsys):
    assert experiments.main(["--dry_run", "--device", "cpu"]) == 0
    printed = capsys.readouterr().out.strip().splitlines()
    want = [line.replace("iris_style_transfer_tpu.workloads.", experiments.MODULE) + " --device cpu"
            for line in _sh_lines()]
    assert len(want) == 27 and printed == want


class _Parsed(Exception):
    pass


@pytest.mark.parametrize("index", range(27))
def test_every_line_parses_with_the_ports_parser(monkeypatch, index):
    argv = experiments.command_lines("cpu")[index]
    assert argv[0] == "-m" and argv[1].startswith(experiments.MODULE)
    name = argv[1][len(experiments.MODULE):]
    module, parses = MAINS[name], PARSES[name]
    seen, real_parse = {}, parses.parse_config

    def parse_only(parser, defaults, args):
        seen["cfg"], seen["args"] = real_parse(parser, defaults, args)
        raise _Parsed

    monkeypatch.setattr(parses, "parse_config", parse_only)
    with pytest.raises(_Parsed):
        module.main(argv[2:])
    flags = dict(zip(argv[2::2], argv[3::2]))
    cfg, args = seen["cfg"], seen["args"]
    assert args.device == "cpu"
    if "-rd" in flags:
        assert (cfg.rotation_prob, cfg.rotation_degree, cfg.perspect_prob, cfg.perspect_degree) == tuple(
            float(flags[k]) for k in ("-rp", "-rd", "-pp", "-pd"))
    if "-estimator" in flags:
        assert (cfg.estimator, cfg.save_period, cfg.epochs) == tuple(
            int(flags[k]) for k in ("-estimator", "--save_period", "-E"))


def test_a_failing_run_stops_the_sweep(monkeypatch, capsys):
    """The first run that fails ends the sweep with its exit code, as set -e."""
    calls = []

    class Done:
        def __init__(self, rc):
            self.returncode = rc

    def run(cmd, check):
        calls.append(cmd)
        return Done(3 if len(calls) == 2 else 0)

    monkeypatch.setattr(experiments.subprocess, "run", run)
    assert experiments.main(["--device", "cpu"]) == 3
    assert len(calls) == 2 and shlex.join(calls[1][1:]) == shlex.join(experiments.command_lines("cpu")[1])
