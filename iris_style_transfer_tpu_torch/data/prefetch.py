"""Aligned batching and background device staging.

Counterpart of ``iris_style_transfer_tpu/data/prefetch.py``.
:func:`batch_iterator` shuffles with ``np.random.default_rng(seed)``, so its
order is the JAX package's, index for index; tensors are indexed on their
own device, so a device-resident dataset is batched without a host round
trip.  :func:`prefetch_to_device` replaces the reference's
``DataLoader(pin_memory=True)``: a thread pins each host batch and copies it
to the device on a side stream while the current step runs.
:func:`background` runs any host iterator (the loaders' frame decode) on a
thread, ahead of the device work that consumes it.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Sequence

import numpy as np
import torch


def _take(a, idx: np.ndarray):
    if isinstance(a, torch.Tensor):
        return a[torch.as_tensor(idx, device=a.device)]
    return a[idx]


def batch_iterator(
    arrays: Sequence,
    batch_size: int,
    shuffle: bool = False,
    seed: int | None = None,
    drop_remainder: bool = False,
    pad_final: bool = True,
) -> Iterator[tuple]:
    """Yield aligned batch tuples from same-length arrays, shuffled with
    ``np.random.default_rng(seed)`` when ``shuffle``.  A short final batch
    is dropped (``drop_remainder``), padded by repeating its last row with a
    boolean validity array appended as the last tuple element
    (``pad_final``), or yielded short."""
    n = len(arrays[0])
    idx = np.arange(n)
    if shuffle:
        np.random.default_rng(seed).shuffle(idx)
    for i in range(0, n, batch_size):
        take = idx[i : i + batch_size]
        if len(take) < batch_size:
            if drop_remainder:
                return
            if pad_final:
                valid = np.zeros(batch_size, bool)
                valid[: len(take)] = True
                take = np.concatenate([take, np.full(batch_size - len(take), take[-1])])
                yield tuple(_take(a, take) for a in arrays) + (valid,)
                continue
        yield tuple(_take(a, take) for a in arrays)


_END = object()


def _background(iterator, size: int, transform):
    """Run ``transform`` over ``iterator`` on a thread with a bounded queue;
    producer errors re-raise in the consumer, and a consumer that stops
    early unblocks the producer."""
    q: queue.Queue = queue.Queue(maxsize=size)
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in iterator:
                if not put(transform(item)):
                    return
            put(_END)
        except Exception as e:  # the consumer re-raises it, with its traceback
            put(e)

    threading.Thread(target=worker, daemon=True).start()
    try:
        while True:
            item = q.get()
            if item is _END:
                return
            if isinstance(item, Exception):
                raise item
            yield item
    finally:
        stop.set()


def background(iterator, size: int = 2):
    """Run a host iterator on a thread with a bounded queue of ``size``
    items, so that decode overlaps the consumer's device work."""
    return _background(iterator, size, lambda item: item)


def prefetch_to_device(iterator, device, size: int = 2) -> Iterator[tuple]:
    """Yield the batches of a host iterator as tensors on ``device``, staged
    ``size`` batches ahead on a thread.  On a CUDA device each array is
    pinned and copied with ``non_blocking=True`` on a side stream; the
    consumer's stream waits for that copy before it uses the batch."""
    device = torch.device(device)
    if device.type != "cuda":
        yield from _background(iterator, size, lambda b: tuple(torch.as_tensor(a).to(device) for a in b))
        return
    stream = torch.cuda.Stream(device)

    def stage(batch):
        with torch.cuda.stream(stream):
            out = tuple(torch.as_tensor(a).pin_memory().to(device, non_blocking=True) for a in batch)
            done = torch.cuda.Event()
            done.record(stream)
        return out, done

    for out, done in _background(iterator, size, stage):
        current = torch.cuda.current_stream(device)
        current.wait_event(done)
        for t in out:
            t.record_stream(current)  # the caching allocator must not reuse it before the step ends
        yield out
