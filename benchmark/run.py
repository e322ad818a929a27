"""Run one cell of the benchmark and print its result as the last line.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Needs a CUDA card (``torch.cuda.is_available()``) and as many as the cell
asks for; without them it exits 2 and prints no result.  It never falls
back to the CPU.  With ``--trace 0`` the metrics are the cell's
end-to-end ones, with ``--trace 1`` its per-layer ones.  The numbers that
decide ``correct`` are printed on standard error, each beside its limit,
and under ``checks`` at the end of the result line.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if sys.path and os.path.abspath(sys.path[0] or ".") == os.path.dirname(os.path.abspath(__file__)):
    sys.path.pop(0)
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=int, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    if args.seed < 0:
        p.error("--seed must be a non-negative whole number")

    import torch

    from benchmark import harness
    from benchmark.device import power_line

    cell = harness.Cell.load(args.workload)
    if not torch.cuda.is_available():
        print("run.py: torch.cuda.is_available() is False; the benchmark needs a CUDA card", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.spec["chips"]:
        print(f"run.py: {args.workload} needs {cell.spec['chips']} cards, "
              f"torch.cuda.device_count() is {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    print(f"[device] {torch.cuda.get_device_name(0)} | {power_line()} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    result = harness.execute(cell, args.seed, args.seconds, bool(args.trace), T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"run.py: JAX or the JAX package was loaded: {', '.join(found)}", file=sys.stderr)
        return 3
    for name, v in result["not_compared"].items():
        print(f"[reading] {name} {v!r} (not compared)", file=sys.stderr)
    print(f"[check] correct {result['correct']}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"[check] {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
