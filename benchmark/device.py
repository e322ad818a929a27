"""The card: its name and power limit, and the peaks every roofline and
``mfu`` is taken against (NVIDIA's H100 SXM data sheet, dense rates)."""

from __future__ import annotations

import subprocess

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}


def bound_s(nbytes: float, flops: float = 0.0, rate: str = "bf16") -> float:
    """The least time the card could take: the larger of the bytes at the
    HBM rate (each input read once, each output written once) and the
    operations at the peak rate of their type."""
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[rate])


def power_line() -> str:
    """nvidia-smi's name and power limit of the first card, or why not."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, check=True, timeout=30).stdout
        return out.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as err:
        return f"nvidia-smi unavailable: {err}"
