"""Host milliseconds a sweep after its last batch: the drain of the metric
worker's jobs (``ist.drain``) and the epoch-end metrics and arrays
(``ist.aggregate``), one span each."""

from benchmark.metrics._spans import program_spans, total_ms


def read(run):
    spans = program_spans(run)
    if not spans:
        return None
    drain, agg = total_ms(spans, "ist.drain", 1, "host"), total_ms(spans, "ist.aggregate", 1, "host")
    return None if drain is None or agg is None else drain + agg
