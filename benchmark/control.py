"""The readings that the limits of a cell's checks are set from.

    python benchmark/control.py --workload <cell> --seconds <s> --program 11 12 ... --control 21 22 23

For each ``--program`` seed: set-up and the measured pass as a run makes
them, then the check's numbers of the program's outputs.  For each
``--control`` seed: the same set-up and pass (so the inputs are the
run's), then the numbers of the control's outputs: the reference one
precision lower (``reference/precision.py:CONTROL``) put in the
program's place.  The kernels are built once for all seeds.  One JSON
line a seed; the lower reading of a number is the largest the program
gives, the upper the smallest the control gives.  Needs a CUDA card.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if sys.path and os.path.abspath(sys.path[0] or ".") == os.path.dirname(os.path.abspath(__file__)):
    sys.path.pop(0)
sys.path.insert(0, ROOT)


def side_readings(workload: str, seed: int, seconds: int, control: bool, device="cuda") -> dict:
    import torch

    from benchmark import harness
    from benchmark.reference.precision import CONTROL

    run = harness.Run(harness.Cell.load(workload), seed, seconds, torch.device(device))
    entry = run.entry = harness.make_entry(run)
    t0 = time.perf_counter()
    entry.setup()
    run.timed = entry.timed_pass()
    entry.release()
    out = entry.control_outputs(CONTROL) if control else None
    readings = entry.judge(out)
    compared = harness.checks(run.cell, readings)
    return {"seed": seed, "side": "control" if control else "program", "batches": run.timed["batches"],
            "seconds": time.perf_counter() - t0, "readings": readings,
            "correct": all(v <= lim for _, v, lim in compared)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=int, required=True)
    p.add_argument("--program", type=int, nargs="*", default=[])
    p.add_argument("--control", type=int, nargs="*", default=[])
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("control.py: needs a CUDA card", file=sys.stderr)
        return 2
    for control, seeds in ((False, args.program), (True, args.control)):
        for seed in seeds:
            print(json.dumps(side_readings(args.workload, seed, args.seconds, control)), flush=True)
            gc.collect()  # a seed's recorder and taps hold each other
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
