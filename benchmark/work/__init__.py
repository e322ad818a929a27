"""FLOP and byte counts of the work items, for the rooflines and ``mfu``.

FLOPs are counted over the reference's own forward (and, for the NST,
the gradient with respect to the image only) at the cell's shapes, on the
meta device under ``torch.utils.flop_counter.FlopCounterMode``, so a count
reads the same work whatever implements it.  Bytes count each input read
once and each output written once.
"""
