"""Device milliseconds a batch of estimator 2's ResNet50 trunk: the
``resnet50.apply`` spans of the traced slice, one a chunk in pre and in
post."""

from benchmark.metrics._spans import chunks_a_batch, per_batch


def read(run):
    chunk = run.cell.config.get("seg_chunk")  # a 2020 configuration's
    return per_batch(run, "resnet50.apply", 2 * chunks_a_batch(run, chunk)) if chunk else None
