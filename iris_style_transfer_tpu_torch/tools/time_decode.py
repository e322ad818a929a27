"""Time the host JPEG decode (``data/csrc/jpeg_decode.cpp``) split by what
surrounds it, on this machine's CPU.

    python3 iris_style_transfer_tpu_torch/tools/time_decode.py [--threads 1 8] [--frames 128]

For each 400x640 JPEG fixture of ``tests/torch_fixtures`` that
``chip_smoke.py`` phase 10 times (gray baseline, colour 4:2:0 baseline,
colour progressive) it prints one JSON line of frames/s, on each thread
count, the faster of two turns taken in turns:

  * ``batch``: ``decode_gray_batch`` over ``--frames`` reads of the file,
    as the loaders call it (a fresh output array, the file read and its
    header parsed per frame, a new thread pool per call);
  * ``memory``: ``decode_jpeg`` on the file's bytes, held in memory, into
    one output buffer per frame that was written before (no file read, no
    fresh pages), on a pool of the same threads;
  * ``header``: the frame-header parse alone, on one thread.

The gap between ``batch`` and ``memory`` is the cost of the file reads,
the fresh output pages and the pool; their scaling from 1 to N threads
says how much of it serializes.  Host only: needs no GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
FIXTURES = os.path.join(ROOT, "tests", "torch_fixtures")
FILES = ("twin_gray_400x640.jpg", "twin_color_420_400x640.jpg", "twin_color_progressive_400x640.jpg")
H, W = 400, 640


def _rate(fn, frames: int) -> float:
    t0 = time.perf_counter()
    fn()
    return frames / (time.perf_counter() - t0)


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--threads", type=int, nargs="+", default=[1, 8])
    p.add_argument("--frames", type=int, default=128)
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import numpy as np

    from iris_style_transfer_tpu_torch.data import decode_gray_batch
    from iris_style_transfer_tpu_torch.utils import jpeg

    n = args.frames
    for name in FILES:
        path = os.path.join(FIXTURES, name)
        with open(path, "rb") as fh:
            data = fh.read()
        out = np.zeros((n, H, W, 1), np.uint8)  # written once, so its pages exist
        jpeg.decode_jpeg(data, path, 1, out[0])  # the decoder built and loaded

        def batch(threads: int) -> None:
            decode_gray_batch([path] * n, H, W, threads=threads, dtype=np.uint8)

        def memory(threads: int) -> None:
            with ThreadPoolExecutor(max_workers=threads) as pool:
                list(pool.map(lambda i: jpeg.decode_jpeg(data, path, 1, out[i]), range(n)))

        rates: dict = {"batch": {}, "memory": {}}
        for threads in [*args.threads, *reversed(args.threads)]:  # in turns; the faster of two
            for kind, fn in (("batch", batch), ("memory", memory)):
                r = _rate(lambda: fn(threads), n)
                rates[kind][threads] = max(r, rates[kind].get(threads, 0.0))
        header = max(_rate(lambda: [jpeg._header(data, path) for _ in range(n)], n) for _ in range(2))
        print(json.dumps({"file": name, "bytes": len(data), "host_cores": os.cpu_count(), "frames": n,
                          "batch_frames_per_s": rates["batch"], "memory_frames_per_s": rates["memory"],
                          "header_parses_per_s": header}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
