"""What the two IST entries share: the recorder of the programs' calls,
an in-memory logger for the sweeps, and the set-up and window of a sweep
pass (K sized from two timed warm-up passes to fill ``--seconds``)."""

from __future__ import annotations

import os
import random
import shutil
import tempfile
import time

import torch

from benchmark.taps import StepTap


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Recorder:
    """Calls of the program's per-batch functions, each timed by CUDA events
    on the card.  Once :meth:`reset`, each entry's wrappers keep the
    outputs of the batches that the check judges, in ``batches`` by batch
    index; an entry's pre-batch program calls :meth:`next_batch`."""

    def __init__(self, device):
        self.device = device
        self.keep = False
        self.judged: set[int] | None = None
        self.index = -1
        self.batches: dict[int, dict] = {}
        self.events: list = []

    def reset(self, judged: set[int] | None = None) -> None:
        """Keep the outputs of the batches in ``judged`` (None: all) and the
        times of every call, from here on."""
        self.keep, self.judged, self.index, self.batches, self.events = True, judged, -1, {}, []

    def next_batch(self) -> None:
        self.index += 1

    @property
    def keeping(self) -> bool:
        return self.keep and (self.judged is None or self.index in self.judged)

    def timed(self, fn, *args, **kw):
        if self.device.type != "cuda":  # a CPU run (the tests): host seconds
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            self.events.append(time.perf_counter() - t0)
            return out
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn(*args, **kw)
        b.record()
        self.events.append((a, b))
        return out

    def programs_ms(self) -> float:
        """Milliseconds of the calls since :meth:`reset`, on the card's clock."""
        sync(self.device)
        return sum(e * 1e3 if isinstance(e, float) else e[0].elapsed_time(e[1]) for e in self.events)


class Logs:
    """A logger for the sweeps that keeps its records in memory."""

    def __init__(self):
        self.records: list[dict] = []

    def log(self, rec: dict) -> None:
        self.records.append(dict(rec))

    def finish(self) -> None:
        pass


class SweepEntry:
    """An entry that drives one of the IST mains' sweep functions.  A
    subclass sets ``rec`` (a :class:`Recorder` of the main's programs) and
    defines ``_sweep(data, closures)``, which hands the main ``self.logs``;
    ``data`` is what it sweeps.  ``main`` names the main's module."""

    main = ""

    def __init__(self, run):
        self.run = run
        self.cfg_json, self.traffic = run.cell.config, run.cell.traffic
        self.device = run.device
        self.seed = run.seed
        self.bs = self.traffic["batch_size"]
        self.closures = self.cfg_json["nst_epochs"]
        self.hw = (self.traffic["frame_height"], self.traffic["frame_width"])
        self.tmp = None
        self.logs = Logs()  # what the main logs; the measured pass's are kept

    def _begin(self):
        """The main's config, a temporary output directory, and the L-BFGS
        tap; returns the compute dtype."""
        from iris_style_transfer_tpu_torch.runtime.config import WorkloadConfig

        c = self.cfg_json
        self.tmp = tempfile.mkdtemp(prefix="ist-") + os.sep
        self.cfg = WorkloadConfig(bs=self.bs, seed=self.seed, compute_dtype=c["compute_dtype"],
                                  history_size=c["lbfgs_history"], stats_taps=c["stats_taps"],
                                  glint_threshold=c["glint_threshold"])
        self.tap = StepTap(self.main).__enter__()
        return torch.bfloat16 if c["compute_dtype"] == "bfloat16" else torch.float32

    def _timed_sweep(self, data, closures: int) -> tuple[float, dict]:
        sync(self.device)
        t0 = time.perf_counter()
        log = self._sweep(data, closures)
        sync(self.device)
        return time.perf_counter() - t0, log

    def _size(self, warm) -> int:
        """Warm every shape of the pass on one batch with a short NST (the
        first call builds or loads the kernels), then time two short passes
        and return the batches that fill ``--seconds`` at the cell's
        closures."""
        n1 = self.traffic["warm_closures"]
        self._sweep(warm, n1)
        t1, _ = self._timed_sweep(warm, n1)
        t2, _ = self._timed_sweep(warm, 4 * n1)
        per_batch = t1 + (self.closures - n1) * (t2 - t1) / (3 * n1)
        return max(1, round(self.run.seconds / per_batch))

    def _pass(self, data, judged: int | None) -> tuple[float, dict]:
        """The measured pass; the NST of one batch drawn from the seed is
        tapped, and ``judged`` batches (None: all) are kept for the check:
        that one, the pass's last (the drain's), and the rest drawn."""
        rng = random.Random(self.seed)
        self.sampled = rng.randrange(self.batches)
        if judged is None:
            self.rec.reset()
        else:
            kept = {self.sampled, self.batches - 1}
            others = [b for b in range(self.batches) if b not in kept]
            self.rec.reset(kept | set(rng.sample(others, max(0, min(len(others), judged - len(kept))))))
        self.tap.arm(self.sampled, (0, 1, self.closures - 1))
        self.logs = Logs()
        wall, log = self._timed_sweep(data, self.closures)
        self.tap.target = None  # the records stay
        self.rec.keep = False
        return wall, log

    def _timed(self, wall: float, nst_batches_per_s: float) -> dict:
        return {"wall_s": wall, "images": self.batches * self.bs, "batches": self.batches,
                "closures": self.closures, "nst_batches_per_s": nst_batches_per_s,
                "pre_post_ms": self.rec.programs_ms() / self.batches}

    def _end(self) -> None:
        """Restore the tapped names, drop the output directory."""
        self.rec.fns = None
        self.tap.__exit__()
        if self.tmp:
            shutil.rmtree(self.tmp, ignore_errors=True)
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
