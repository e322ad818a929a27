"""Device milliseconds a batch of the per-batch programs (pre, post and
re-segmentation), in CUDA events around each call of the recorder-wrapped
programs."""


def read(run):
    return run.timed.get("pre_post_ms")
