"""Milliseconds of a batch outside the NST: the pass's wall time per batch
less the NST's, which the main's own timer gives (``nst_batches_per_sec``,
a synchronize inside, the first batch left out)."""


def read(run):
    t = run.timed
    if not t.get("nst_batches_per_s"):
        return None
    return (t["wall_s"] / t["batches"] - 1.0 / t["nst_batches_per_s"]) * 1e3
