"""Device milliseconds a batch of RITnet's re-segmentation: the
``ritnet.apply`` spans of the traced slice, one a chunk."""

from benchmark.metrics._spans import RITNET_CHUNK, chunks_a_batch, per_batch


def read(run):
    return per_batch(run, "ritnet.apply", chunks_a_batch(run, RITNET_CHUNK))
