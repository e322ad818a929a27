"""Host milliseconds a batch of getting the batch to the programs: the
``ist.load`` spans (the fetch and shard; one more than the batches, the
fetch that ends the loop) and the ``ist.stage`` spans (the 2020 pre
program's quantize and host-to-card copy; one a batch, none in 2019)."""

from benchmark.metrics._spans import batches, count, program_spans, total_ms


def read(run):
    spans = program_spans(run)
    if not spans or not batches(spans):
        return None
    b = batches(spans)
    load = total_ms(spans, "ist.load", b + 1, "host")
    stage = total_ms(spans, "ist.stage", b if count(spans, "ist.stage") else 0, "host")
    return None if load is None or stage is None else (load + stage) / b
