"""The full experiment sweep on the port: ``experiments.sh``'s 27 runs.

    python -m iris_style_transfer_tpu_torch.experiments [--device cuda] [--dry_run]

The reference's reproduction recipe, line for line and in its order, with
``iris_style_transfer_tpu_torch.workloads.*`` in place of the JAX
package's mains: the classification trainer without augmentation, with 10
rotation degrees and with 12 perspective degrees; both gaze estimators;
then the two IST mains.  ``--device`` goes to every run.  The sweep stops
at the first run that fails and exits with its code, as ``set -e`` does.
``--dry_run`` prints the command lines and runs nothing.
"""

from __future__ import annotations

import argparse
import shlex
import subprocess
import sys

MODULE = "iris_style_transfer_tpu_torch.workloads."
ROTATION_DEGREES = ("5", "10", "20", "30", "45", "60", "90", "120", "150", "180")
PERSPECTIVE_DEGREES = ("0.01", "0.05", "0.1", "0.2", "0.3", "0.4", "0.5", "0.6", "0.7", "0.8", "0.9", "1.0")


def command_lines(device: str) -> list[list[str]]:
    """Each run's argv after ``python``, in ``experiments.sh``'s order:
    ``-m <module> <flags> --device <device>``."""
    runs = [("iris_classification", ["-rp", "0", "-rd", "0", "-pp", "0", "-pd", "0"])]
    runs += [("iris_classification", ["-rp", "1", "-rd", rd, "-pp", "0", "-pd", "0"]) for rd in ROTATION_DEGREES]
    runs += [("iris_classification", ["-rp", "0", "-rd", "0", "-pp", "1", "-pd", pd]) for pd in PERSPECTIVE_DEGREES]
    runs += [("gaze_estimation", ["-estimator", "1", "--save_period", "10", "-E", "250"]),
             ("gaze_estimation", ["-estimator", "2", "--save_period", "50", "-E", "500"]),
             ("ist_openeds2019", []),
             ("ist_openeds2020", [])]
    return [["-m", MODULE + main, *flags, "--device", device] for main, flags in runs]


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", type=str, default="cuda", help="torch device for every run")
    p.add_argument("--dry_run", action="store_true", help="print the command lines, run nothing")
    args = p.parse_args(argv)
    for line in command_lines(args.device):
        print(shlex.join(["python", *line]), flush=True)
        if args.dry_run:
            continue
        rc = subprocess.run([sys.executable, *line], check=False).returncode
        if rc:
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
