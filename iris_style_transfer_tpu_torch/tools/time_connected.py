"""Time the labelling kernel (``ops/csrc/connected.cu``) and the functions
that wait on it, on one GPU, split by kernel.

    python3 iris_style_transfer_tpu_torch/tools/time_connected.py [--root DIR] [--out FILE]

``--root`` is the checkout whose ``iris_style_transfer_tpu_torch`` is
timed (default: the one holding this script), so that the same script
times another tree's kernels, such as a ``git archive`` of an earlier
commit, on the same inputs: 64 synthetic-twin frames at 400x640 through
the bundled RITnet to their iris masks (as ``chip_smoke.py``'s
``phase_connected``), seeded noise at 0.45, an all-true and an all-false
mask (the cost of empty tiles), each at both connectivities.  For each it prints one JSON line:

  * ``ms``: CUDA events over 20 calls after 3 warm-ups, the lower of two
    turns, of ``connected_components``, ``largest_component``,
    ``area_opening(area_threshold=500)`` and, where the tree has it,
    ``connected_components_with_areas``;
  * ``split``: each kernel's device ms a call from ``torch.profiler`` over
    10 calls of each function (every kernel it launches, by name);
  * ``bound_ms``: the bytes of the labels-only call (1 + 4 per pixel) and
    of the call with areas (1 + 4 + 4 per pixel) at 3.35 TB/s.

Needs a CUDA device; exits with an error without one.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import subprocess
import sys

HBM_BYTES_PER_S = 3.35e12  # NVIDIA's H100 SXM data sheet
FRAMES, H, W = 64, 400, 640
SEED = 0  # chip_smoke.py's: its frames are synthetic_eye_batch(seed=SEED + 9)
ITERS, PROFILED = 20, 10


def _time_ms(fn, iters: int = ITERS) -> float:
    import torch

    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _turns(fns: dict) -> dict:
    """Each callable timed twice, in turns (a, b, ..., b, a); the lower."""
    names = list(fns)
    t = {k: [] for k in names}
    for order in (names, names[::-1]):
        for k in order:
            t[k].append(_time_ms(fns[k]))
    return {k: min(v) for k, v in t.items()}


@functools.cache
def _traced():
    """``runtime/profiler.py:traced`` of the checkout holding this script,
    loaded from its file, so that a ``--root`` without it (an earlier
    commit) is timed by the same retries."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "runtime", "profiler.py")
    spec = importlib.util.spec_from_file_location("_time_connected_profiler", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.traced


def _device_events(ev) -> list:
    return [e for e in ev if "cuda" in str(getattr(e, "device_type", "")).lower()
            and getattr(e, "self_device_time_total", 0) > 0]


def _split(fn) -> dict:
    """Device ms a call of each kernel ``fn`` launches, by kernel name: its
    mean time times its launches a call; a trace without device events is
    taken again (``traced``: the profiler drops events on the H100), and
    none after every try gives an empty split."""
    import torch

    fn()
    torch.cuda.synchronize()
    try:
        ev, _ = _traced()(lambda: [fn() for _ in range(PROFILED)], lambda ev: bool(_device_events(ev)),
                          "the kernels of a labelling call", cpu=False)
    except AssertionError:
        return {}
    return {e.key: e.self_device_time_total / e.count * max(1, round(e.count / PROFILED)) / 1e3
            for e in _device_events(ev)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
    ap.add_argument("--out", default="", help="also append the JSON lines to this file")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("time_connected: torch.cuda.is_available() is False; this timing needs a GPU")
    from iris_style_transfer_tpu_torch.data import synthetic_eye_batch
    from iris_style_transfer_tpu_torch.models import RITnet
    from iris_style_transfer_tpu_torch.ops import connected as cc
    from iris_style_transfer_tpu_torch.pipelines.iris import iris_mask_from_seg

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"[time_connected] package {os.path.dirname(cc.__file__)} on {smi}", flush=True)
    frames = torch.from_numpy(synthetic_eye_batch(FRAMES, H, W, seed=SEED + 9)[0]).cuda()
    torch.backends.cudnn.deterministic, torch.backends.cudnn.allow_tf32 = True, False
    with torch.no_grad():
        seg = RITnet.apply(RITnet.pretrained(device="cuda"), frames)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 10)
    full = (FRAMES, H, W)
    cases = [("RITnet iris masks", iris_mask_from_seg(seg, frames)[..., 0].contiguous()),
             ("noise 0.45", torch.rand(full, generator=gen, device="cuda") < 0.45),
             ("all true", torch.ones(full, dtype=torch.bool, device="cuda")),
             ("all false", torch.zeros(full, dtype=torch.bool, device="cuda"))]
    with_areas = getattr(cc, "connected_components_with_areas", None)
    lines = []
    for what, m in cases:
        for conn in (2, 1):
            fns = {"connected_components": lambda: cc.connected_components(m, conn),
                   "largest_component": lambda: cc.largest_component(m, conn),
                   "area_opening": lambda: cc.area_opening(m, 500, conn)}
            if with_areas is not None:
                fns["connected_components_with_areas"] = lambda: with_areas(m, conn)
            px = m.numel()
            rec = {"case": what, "shape": list(m.shape), "connectivity": conn,
                   "foreground": int(m.sum()), "ms": _turns(fns),
                   "split": {k: _split(f) for k, f in fns.items()},
                   "bound_ms": {"labels": 5 * px / HBM_BYTES_PER_S * 1e3,
                                "labels_and_areas": 9 * px / HBM_BYTES_PER_S * 1e3},
                   "card": smi}
            lines.append(json.dumps(rec))
            print(lines[-1], flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "a") as fh:
            fh.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
