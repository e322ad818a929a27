"""NST closures a second: the main's ``nst_batches_per_sec`` times the
cell's closures a batch."""


def read(run):
    t = run.timed
    if not t.get("nst_batches_per_s"):
        return None
    return t["nst_batches_per_s"] * t["closures"]
