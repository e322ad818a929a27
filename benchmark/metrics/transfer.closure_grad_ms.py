"""Device milliseconds a batch of the NST closures' loss and gradient: the
``nst.grad`` spans of the traced slice, one a closure."""

from benchmark.metrics._spans import per_batch


def read(run):
    return per_batch(run, "nst.grad", run.cell.config["nst_epochs"])
