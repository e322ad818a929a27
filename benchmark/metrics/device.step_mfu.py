"""Model FLOPs of the whole measured pass (``work/``, per batch, times the
batches) over the pass's seconds times the card's bf16 dense peak."""

from benchmark.device import PEAK_FLOPS


def read(run):
    flops = run.work.get("flops")
    if not flops:
        return None
    return 100.0 * flops * run.timed["batches"] / (run.timed["wall_s"] * PEAK_FLOPS["bf16"])
