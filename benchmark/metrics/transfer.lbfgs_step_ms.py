"""Device milliseconds a batch of the NST's compact L-BFGS steps: the
``lbfgs.step`` spans of the traced slice, one a closure."""

from benchmark.metrics._spans import per_batch


def read(run):
    return per_batch(run, "lbfgs.step", run.cell.config["nst_epochs"])
