"""The share of the traced slice's wall time in which no operation ran on
the card (the union of the device intervals in the trace)."""


def read(run):
    tr = run.trace
    if tr is None or tr.window_s <= 0 or tr.busy_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
