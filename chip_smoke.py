#!/usr/bin/env python3
"""End-to-end check that the PyTorch port runs on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each; any failure is an uncaught exception and a non-zero
exit:

  1. device  — CUDA must be available; prints the card's name and power
               limit as nvidia-smi reports them.
  2. build   — builds the hand-written kernels from ``ops/csrc`` with nvcc,
               one nvcc per source, all started together.
  3. kernels — each kernel against its plain torch version on the card at
               the shapes the main paths give it and at more, with f32 and
               odd cases: relu_pool and relu_stats bit-exact (y, g) with
               planted ties, zeros and negatives, relu_stats' sums and the
               Gram within their stated tolerances (``ops/relu_stats.py``,
               ``ops/blockwise_gram.py``; the Gram at the 2019 relu1_1 and
               the 512-px bs-4 tap shapes, against a bmm with TF32 off),
               dw_conv_bn_silu within its tolerance (``ops/depthwise.py``)
               at every distinct B7 shape of a 400x640 chunk and at the
               kernel's other paths (C not a multiple of 8, W shorter than
               a thread's run, H = 1, x off 16-byte alignment; both
               dtypes), conv1 within one bf16 ulp (f32: 1e-5 of max|y|,
               also against an f64 conv; ``ops/conv1.py``) at the 224-px
               bs-64 and 512-px bs-4 conv1_1 shapes and odd ones (C_in 1,
               2, 3 and 4, C_out 40, 60 and 128, H and W off the tile);
               times each against its plain version and, where one
               PyTorch call computes the same function, that call, in
               turns (depthwise at every B7 shape, also in device time
               from torch.profiler against cuDNN's, with the per-forward
               sums against the bound; conv1 at both shapes); checks with
               torch.profiler and the launch counts that a VGG19 forward
               (+backward, plain and with stats taps; bf16 conv1_1 on the
               tensor-core kernel), a Gram-loss closure (the Gram's
               tensor-core kernel; an f32 Gram its CUDA-core one) and a B7
               U-Net apply launch them.
  3b. connected — the union-find labelling (``ops/connected.py``; tile,
               seam and finalize kernels), its labels and its fused
               per-label areas bit-exact against the plain version at (64,
               400, 640), both connectivities: RITnet's iris masks of 64
               twin frames, noise at 0.3, 0.45 and 0.6, a serpentine, all
               false, all true, B = 1, ragged tiles ((64, 401, 639), (3, 1,
               640), (3, 400, 1)), stripes on the tile seams and a
               checkerboard; the lower label on a tie; then, launches
               counted, ``mask_and_crop_iris(use_area_opening=True)`` at bs
               64, ``extract_eye_landmarks(select_largest=True)`` and
               ``GazeEstimator1Complicated`` at bs 8, against the CPU path;
               the kernel's time, labels only and with areas, against the
               plain version's and the two bounds, and largest_component
               and area_opening end to end.
  4. nst     — the production NST loop (bf16 compute, bf16 L-BFGS history,
               m = 10) at (64, 3, 224, 224) on seeded VGG19 weights, once
               with the classic BN taps and once with the stats taps (their
               s_loss histories compared); then the Gram-loss loop at
               (4, 3, 512, 512), and one Gram-loss closure's wall time,
               device time and the Gram kernels' device time.  After one warm-up closure each loop runs
               under ``torch.cuda.set_sync_debug_mode("error")``, so a host
               sync inside it fails the run.
  5. main    — ``workloads.ist_openeds2019.main`` in-process on the
               synthetic twin at batch 64 and 20 NST closures, without and
               with ``--stats_taps on``; the kernels' launch counts are
               reset just before and read just after, and with stats taps
               they must be 4 x (closures + 2) forward and 4 x closures
               backward per NST call.
  6. main2020 — ``workloads.ist_openeds2020.main`` in-process on the gaze
               twin (24 frames in one batch of 128, 400x640, B7 U-Net +
               ResNet50 + both estimators at full width, 20 closures),
               without and with ``--stats_taps on``; counts as in 5, and
               the depthwise kernel must launch exactly 102 x (1 + 2 x 128
               / SEG_CHUNK) times; then a timing breakdown of the batch body.
  7. demos   — ``demos.nst_demo --gram --sw 1e6 --size 512`` (exactly 4 x
               (closures + 1) Gram launches) and ``demos.iris_nst_demo``, in-process
               on the card, writing their PNGs to a temporary directory.
  8. train2019 — ``workloads.iris_classification.main`` at full width
               (VGG19 at 224x224, bs 64, bf16) on a twin of 8 users x 40
               frames (4 steps per epoch): two epochs with VGG19 frozen,
               one with ``--no-freeze_vgg``; conv1 and relu_pool launch
               once per VGG19 pass, relu_pool_bwd once per trained step.
               Then ``ist_openeds2019`` reads the trainer's checkpoint
               through ``-path1/-path2``.
  9. train_gaze — ``workloads.gaze_estimation.main`` with each estimator
               at bs 32 (3 learning rates x 3 steps), then one timed
               estimator-2 step at the JAX default bs 128 (or the largest
               of 96 and 64 that fits) with its peak memory.

 10. real_data — the four mains from fake OpenEDS2019 and OpenEDS2020
               trees written at 400x640 from the twin
               (``data/fake_openeds.py``; every PNG row filter): the 2019
               IST main and ``iris_classification`` at bs 64, the 2020 IST
               main at bs 128 (its prediction files bit-equal, with cuDNN's
               deterministic algorithms, to those of the same frames fed
               from memory in the stream's order; depthwise 102 x (1 + 2 x
               128 / SEG_CHUNK)), ``gaze_estimation`` with estimator 1
               (102 depthwise launches per B7 apply of the landmark
               extraction) and estimator 2 (bs 128, streamed); the decode
               rate per filter type on 1 thread and on the loader's 8,
               beside the estimator-2 trainer's frames/s.
 11. replicate — the three replication tools (``tools/``) in-process at
               full width (400x640 twin frames) and cut depth, in a
               temporary directory: every summary key present and finite,
               B7's training loss falling, launches as the cuts derive
               them; then one B7 training step at bs 2 split into the
               depthwise forward kernel, the plain f32 depthwise backward
               and the rest, in device time, beside its wall time.
 12. parallel — the mains on ranks of a process group (``parallel/``),
               spawned by ``run_ranks``, cuDNN deterministic: on an NCCL
               group of one, the 2019 main (bs 64, stats taps on) bit-equal
               to one process, the NST loop under the sync check, closures/s
               without and with the group; on two gloo ranks sharing the
               card (NCCL refuses two ranks on one card), the 2019 and 2020
               mains, the classifier trainer with ``--model_parallel 2`` and
               the gaze trainer against one process, each rank's launches as
               derived for its half of the batch; then the 2019 main (bs 64,
               stats taps on) and the 2020 main (bs 128) with
               ``--model_parallel 2`` (each NST image's H split over the two
               ranks, the kernels on the slabs) against one process, the
               first closures' style losses to 1e-5 and each rank's
               launches those of one process (a model rank runs its data
               block whole outside the NST and its slab in it); and VGG19
               at (64, 3, 224, 224) bf16 split on H over the two ranks,
               forward and backward, taps and gradients against one
               process's within SPLIT_REL_TOL.

``python3 chip_smoke.py --cards N`` (N cards, N even) runs phases 1-2 and
then ``phase_cards`` alone: the IST mains and the classifier trainer (heads
split over 2) on N NCCL ranks, one a card, against one card, and the NST
loop at a joint bs 64; on four cards also the NST loop at joint bs 4 and
64 on the (data, model) layouts 1 × 4, 2 × 2 and 4 × 1 and on
``make_multislice_mesh(2)`` and ``(2, model_parallel=2)``, with the halo
exchanges' share of a closure; the last two lines as below.

In every main-path phase conv1 launches exactly once per VGG19 pass.

The lines before the last are the kernel report ({"kernels": [...]}) and
the nvidia-smi line; the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

# the checkout's root first, whatever the interpreter's mode (-I and -P
# leave the script's directory off sys.path)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

NST_CLOSURES = 200
GRAM_NST_CLOSURES = 40
MAIN_CLOSURES = 20
DEMO_CLOSURES = 20
GRAM_STYLE_WEIGHT = 1e6  # Gatys' style weight; see phase_nst_gram
SEED = 0
# the 2019 style taps relu{1..4}_1 at batch 64 and the Gram NST's at
# (4, 3, 512, 512), as (B, C, H, W)
TAPS_2019 = ((64, 64, 224, 224), (64, 128, 112, 112), (64, 256, 56, 56), (64, 512, 28, 28))
TAPS_512 = ((4, 64, 512, 512), (4, 128, 256, 256), (4, 256, 128, 128), (4, 512, 64, 64))


# NVIDIA's H100 SXM data sheet, dense: HBM bytes/s and the peak op rates
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}
TRAIN_USERS, TRAIN_FRAMES_PER_USER = 8, 40  # the trainer's twin: 4 steps per epoch at bs 64
# first on every main's command line: one process, however many cards the host
# has (--n_devices 0 spawns a rank per card); a later --n_devices N wins
ONE_PROCESS = ("--n_devices", "1")


def _log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def _bound(nbytes: float, flops: float = 0.0, rate: str = "bf16") -> tuple[float, str]:
    """The least time the card could take, in ms: the larger of the bytes
    the function must move (each input read once, each output written once)
    at the HBM rate and its operations at the peak rate of their type;
    returns (ms, "bytes" or "operations")."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / PEAK_FLOPS[rate] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this check needs a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    _log("device", f"{torch.cuda.get_device_name(0)} | torch {torch.__version__} cuda {torch.version.cuda}")
    print(smi, flush=True)
    return smi


def phase_build():
    from iris_style_transfer_tpu_torch.ops import (blockwise_gram, connected, conv1, cuda_build, depthwise, relu_pool,
                                                   relu_stats)

    t0 = time.perf_counter()
    mods = (relu_pool, depthwise, relu_stats, blockwise_gram, conv1, connected)
    with ThreadPoolExecutor(max_workers=len(mods)) as pool:  # one nvcc per source, together
        for f in [pool.submit(m._library) for m in mods]:
            f.result()
    for m in mods:
        info = cuda_build.BUILD_INFO[m.SOURCE]
        _log("build", f"{m.SOURCE}: nvcc {info['seconds']:.1f} s; " + " | ".join(_resources(info["log"])))
    _log("build", f"all kernels built and loaded in {time.perf_counter() - t0:.1f} s")


def _resources(ptxas_log: str) -> list[str]:
    """Each kernel of an ``nvcc -Xptxas=-v`` log with its registers, stack
    frame and spill bytes, the kernel's name demangled where c++filt is
    on the PATH."""
    import re
    import shutil

    out, name, frame = [], "?", ""
    for ln in ptxas_log.splitlines():
        if "Function properties for" in ln:
            name = ln.split("Function properties for", 1)[1].strip()
        elif "bytes stack frame" in ln:
            frame = ln.strip()
        elif "Used" in ln and "registers" in ln:
            regs = re.search(r"Used (\d+) registers", ln).group(1)
            out.append((name, f"{regs} registers, {frame}"))
            name, frame = "?", ""
    if shutil.which("c++filt") and out:
        names = subprocess.run(["c++filt"], input="\n".join(n for n, _ in out), capture_output=True,
                               text=True, check=False).stdout.splitlines()
        if len(names) == len(out):
            out = [(d.replace("(anonymous namespace)::", "").removeprefix("void ").split("(", 1)[0], r)
                   for d, (_, r) in zip(names, out)]
    return [f"{n}: {r}" for n, r in out]


def _tied(shape_nhwc, dtype, gen):
    """NCHW channels_last tensor on the card whose values sit on a coarse
    grid, so windows hold exact ties, zeros and all-negative quadruples."""
    import torch

    x = torch.randn(shape_nhwc, generator=gen, device="cuda")
    x = torch.round(x * 2) / 2  # steps of 0.5: many exact ties, many zeros
    x[:, 0:2, 0:2, :] = 0.0
    x[:, 2:4, 0:2, :] = -1.5
    return x.to(dtype).permute(0, 3, 1, 2)


def _time_ms(fn, iters: int = 20) -> float:
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


def _turns(fns: dict, iters: int = 20) -> dict:
    """Each callable timed twice, in turns (a, b, b, a); the lower time."""
    names = list(fns)
    t = {k: [] for k in names}
    for order in (names, names[::-1]):
        for k in order:
            t[k].append(_time_ms(fns[k], iters))
    return {k: min(v) for k, v in t.items()}


PROFILER_TRIES = 4


def _trace(fn, ok, what: str, cpu: bool = True):
    """Key averages of ``fn`` (then a device sync) under torch.profiler,
    and the number of traces that took.  On the H100 the profiler drops
    kernel events: after a process's first few traces, the first kernel
    of each trace, and now and then every event of several short traces
    in a row.  So a trace that ``ok`` rejects is taken again after a
    pause, up to PROFILER_TRIES times in all; raises naming ``what`` if
    none passes.  A caller that counts launches around this call counts
    those of every try."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA] if cpu else [ProfilerActivity.CUDA]
    for tries in range(1, PROFILER_TRIES + 1):
        if tries > 1:
            time.sleep(1.0)
        with profile(activities=acts) as prof:
            fn()
            torch.cuda.synchronize()
        ev = prof.key_averages()
        if ok(ev):
            if tries > 1:
                _log("profiler", f"{what}: traced on try {tries}")
            return ev, tries
    raise AssertionError(f"torch.profiler did not trace {what} in {PROFILER_TRIES} tries")


def _device_events(ev) -> list:
    return [e for e in ev if "cuda" in str(getattr(e, "device_type", "")).lower()
            and getattr(e, "self_device_time_total", 0) > 0]


def _queued_ms(fn, n: int) -> float:
    """Time per call of ``fn`` in CUDA events around ``n`` calls queued
    behind a sleep kernel: the host enqueues them all while the card
    sleeps, so they run back to back and the host's launch time is
    hidden, as in device time."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)  # about 10 ms at the H100's clock
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def _device_ms(fn, n: int = 5) -> float:
    """Device time per call of ``fn`` from ``n`` calls traced by
    torch.profiler: each kernel's mean time times the launches of it one
    call makes (its traced count over ``n``, at least 1), so that an event
    the profiler drops does not shrink the sum.  Where no trace holds a
    device event, the calls are timed by ``_queued_ms`` instead, and the
    log says so."""
    import torch

    fn()
    torch.cuda.synchronize()
    try:
        ev, _ = _trace(lambda: [fn() for _ in range(n)], lambda ev: bool(_device_events(ev)),
                       "a timed call's kernels", cpu=False)
    except AssertionError as err:
        ms = _queued_ms(fn, n)
        _log("profiler", f"{err}; {ms:.4f} ms a call in CUDA events behind a queued sleep instead")
        return ms
    return sum(e.self_device_time_total / e.count * max(1, round(e.count / n)) for e in _device_events(ev)) / 1e3


def _check_pair(shape_nhwc, dtype, gen):
    import torch
    from iris_style_transfer_tpu_torch.ops import relu_pool as rp

    x = _tied(shape_nhwc, dtype, gen)
    b, h, w, c = shape_nhwc
    ct = torch.randn((b, h // 2, w // 2, c), generator=gen, device="cuda").to(dtype).permute(0, 3, 1, 2)
    y_k, y_p = rp._kernel_fwd(x), rp.relu_pool_fwd_plain(x)
    g_k, g_p = rp._kernel_bwd(x, y_k, ct), rp.relu_pool_bwd_plain(x, y_p, ct)
    torch.cuda.synchronize()
    err_f = (y_k.float() - y_p.float()).abs().max().item()
    err_b = (g_k.float() - g_p.float()).abs().max().item()
    if not (torch.equal(y_k, y_p) and torch.equal(g_k, g_p)):
        raise AssertionError(f"relu_pool kernel != plain at {shape_nhwc} {dtype}: fwd {err_f}, bwd {err_b}")
    n_tied = int(((g_p != 0).reshape(b, c, h // 2, 2, w // 2, 2).sum(dim=(3, 5)) > 1).sum())
    return x, ct, y_k, err_f, err_b, n_tied


def phase_kernels(card: str):
    """Kernel vs plain on the card (bit-exact), timing, profiler proof."""
    import torch
    from iris_style_transfer_tpu_torch.models import VGG19
    from iris_style_transfer_tpu_torch.ops import relu_pool as rp

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    x, ct, y, err_f, err_b, n_tied = _check_pair((64, 224, 224, 64), torch.bfloat16, gen)
    _log("kernels", f"(64,224,224,64) bf16 fwd+bwd bit-exact vs plain; {n_tied} windows pass the "
         "cotangent to more than one element")
    for shape, dtype in (((4, 512, 512, 64), torch.bfloat16), ((3, 10, 14, 5), torch.float32)):
        _check_pair(shape, dtype, gen)
        _log("kernels", f"{shape} {str(dtype)[6:]} fwd+bwd bit-exact vs plain")

    import torch.nn.functional as F

    ms = _turns({"fwd_plain": lambda: rp.relu_pool_fwd_plain(x), "fwd": lambda: rp._kernel_fwd(x),
                 "fwd_lib": lambda: torch.relu(F.max_pool2d(x, 2)),
                 "bwd_plain": lambda: rp.relu_pool_bwd_plain(x, y, ct), "bwd": lambda: rp._kernel_bwd(x, y, ct)})
    bound_f, bound_b = _bound(_nbytes(x, y)), _bound(_nbytes(x, y, ct, x))
    _log("kernels", f"(64,224,224,64) bf16 ms/call on {card}: fwd {ms['fwd']:.4f} (plain "
         f"{ms['fwd_plain']:.4f}, max_pool2d+relu {ms['fwd_lib']:.4f}, bound {bound_f[0]:.4f}), bwd {ms['bwd']:.4f} "
         f"(plain {ms['bwd_plain']:.4f}, bound {bound_b[0]:.4f})")
    del x, ct, y

    # the main path launches the kernels: one VGG19 forward+backward traced
    params = VGG19.init(torch.Generator().manual_seed(SEED), device="cuda")
    img = torch.rand((64, 3, 224, 224), generator=gen, device="cuda").requires_grad_(True)

    def fwd_bwd():
        _, c, s = VGG19.apply(params, img, compute_dtype=torch.bfloat16, truncate=True)
        loss = sum(f.float().square().mean() for f in [*c, *s])
        torch.autograd.grad(loss, img)

    fwd_bwd()
    torch.cuda.synchronize()
    names = ("relu_pool_fwd_kernel", "relu_pool_bwd_kernel")
    ev, _ = _trace(lambda: [fwd_bwd() for _ in range(3)],  # three passes: the profiler has missed single launches
                   lambda ev: all(any(k in e.key for e in ev) for k in names),
                   "relu_pool_fwd_kernel and relu_pool_bwd_kernel in three VGG19 forward+backward passes")
    device_us = sum(getattr(e, "self_device_time_total", 0) for e in ev if any(k in e.key for k in names))
    _log("kernels", f"profiler: relu_pool_fwd_kernel and relu_pool_bwd_kernel traced in three VGG19 "
         f"fwd+bwd at (64,3,224,224) bf16 ({device_us / 3000:.3f} ms device time a pass)")
    return {"err_fwd": err_f, "err_bwd": err_b, "bound_fwd": bound_f, "bound_bwd": bound_b, **ms}


def _b7_depthwise_shapes():
    """Distinct (k, C, H, W) of the stride-1 MBConv depthwise convs of one
    B7 forward on a 416x640 padded frame, and how many blocks take each."""
    from iris_style_transfer_tpu_torch.models.efficientnet import depthwise_shapes

    shapes = depthwise_shapes(416, 640)
    if sum(shapes.values()) != 51:
        raise AssertionError(f"expected 51 stride-1 depthwise blocks in B7, got {sum(shapes.values())}")
    return shapes


def _dw_inputs(shape_nhwc, k, dtype, gen, offset: int = 0):
    """Random x, weight, and folded-BN a (away from 1) and b (away from 0);
    ``offset`` elements into its storage (an offset of 1 leaves x off
    16-byte alignment)."""
    import torch

    b, h, w, c = shape_nhwc
    n = b * h * w * c
    x = torch.randn(n + offset, generator=gen, device="cuda").to(dtype)[offset:].view(shape_nhwc).permute(0, 3, 1, 2)
    wt = (torch.randn((c, 1, k, k), generator=gen, device="cuda") * 0.3).to(dtype)
    a = torch.rand(c, generator=gen, device="cuda") * 1.5 + 0.5
    bias = torch.randn(c, generator=gen, device="cuda")
    return x, wt, a, bias


def _b7_card_vs_cpu(device: str = "cuda") -> dict:
    """The B7 U-Net with the kernel on the card against the port's CPU
    path (the plain version, which the CPU tests hold to the JAX package)
    on a small input, in float32 with TF32 off.  The weights are drawn at
    fan-in scale with batchnorm off the identity and the head's bias
    centring each class's mean logit, so the labels hold every class (the
    default seeded init labels everything background).  Fails beyond rtol
    1e-3 on the logits or below 99% equal labels."""
    import torch
    from iris_style_transfer_tpu_torch.data import synthetic_eye_batch
    from iris_style_transfer_tpu_torch.models import EfficientNet
    from iris_style_transfer_tpu_torch.ops.image import imagenet_normalize

    cpu_gen = torch.Generator().manual_seed(SEED + 3)

    def draw(path, t):
        if path[-1] == "w":
            return torch.randn(t.shape, generator=cpu_gen) / math.sqrt(t[0].numel())
        if path[-1] in ("scale", "var"):
            return torch.rand(t.shape, generator=cpu_gen) + 0.5
        return torch.randn(t.shape, generator=cpu_gen) * 0.1

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, path) for v in node]
        return draw(path, node)

    params = walk(EfficientNet.init(torch.Generator().manual_seed(SEED)), ())
    imgs = torch.from_numpy(synthetic_eye_batch(2, 48, 64, seed=SEED)[0])
    x = torch.nn.functional.pad(imgs.repeat_interleave(3, dim=-1), (0, 0, 0, 0, 8, 8)).permute(0, 3, 1, 2)
    x = imagenet_normalize(x).contiguous(memory_format=torch.channels_last)
    with torch.no_grad():  # centre each class's mean logit, so that the argmax takes every class
        params["head"]["b"] -= EfficientNet.logits(params, x).mean(dim=(0, 2, 3))
    params_dev = _to_device(params, device)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            lg_cpu = EfficientNet.logits(params, x)
            lg_dev = EfficientNet.logits(params_dev, x.to(device)).cpu()
            lab_cpu = EfficientNet.apply(params, imgs)
            lab_dev = EfficientNet.apply(params_dev, imgs.to(device)).cpu()
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    err = ((lg_dev - lg_cpu).abs().max() / lg_cpu.abs().max()).item()
    equal = (lab_dev == lab_cpu).float().mean().item()
    classes = torch.bincount(lab_cpu.flatten().long(), minlength=4).tolist()
    if err > 1e-3 or equal < 0.99 or min(classes) == 0:
        raise AssertionError(f"B7 on the card vs the CPU path: logits rel err {err}, labels equal {equal}, "
                             f"classes {classes}")
    return {"logit_err": err, "labels_equal": equal, "classes": classes}


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, device) for v in tree]
    return tree.to(device)


def _dw_grad_check(shape_nhwc, k, dtype, gen) -> float:
    """The Function's gradient (kernel forward, plain f32 backward) in x, w,
    a and b against autograd through the plain version under one cotangent,
    on the same values in float32 and cast once to each input's dtype (in
    bf16, autograd would sum the k^2 taps' dx contributions in bf16);
    returns the worst error relative to its gradient's largest magnitude.
    Bound: 1e-5 in float32; 1e-2 in bfloat16, where dx and dw are bf16 (an
    ulp is 2^-8 of the value)."""
    import torch
    from iris_style_transfer_tpu_torch.ops import depthwise as dw

    x, wt, a, bias = _dw_inputs(shape_nhwc, k, dtype, gen)
    ct = torch.randn(x.shape, generator=gen, device="cuda").to(dtype).contiguous(memory_format=torch.channels_last)
    leaves = [t.detach().clone().requires_grad_(True) for t in (x, wt, a, bias)]
    got = torch.autograd.grad(dw.dw_conv_bn_silu(*leaves, k), leaves, ct)
    ref = [t.detach().float().requires_grad_(True) for t in (x, wt, a, bias)]
    want = torch.autograd.grad(dw.dw_conv_bn_silu_plain(*ref, k), ref, ct.float())
    worst = max((g.float() - p.to(g.dtype).float()).abs().max().item() / p.abs().max().item()
                for g, p in zip(got, want))
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    if not worst <= tol:
        raise AssertionError(f"dw_conv_bn_silu gradient at {shape_nhwc} k{k} {dtype}: {worst:.3g} of the "
                             f"largest gradient against autograd through the plain version (bound {tol:g})")
    return worst


def phase_kernels_depthwise(card: str, chunk: int):
    """dw_conv_bn_silu against its plain version at every B7 shape of a
    chunk, timing in turns, and a profiler proof on one B7 U-Net apply."""
    import torch
    from iris_style_transfer_tpu_torch.models import EfficientNet
    from iris_style_transfer_tpu_torch.ops import depthwise as dw

    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    b7 = _b7_depthwise_shapes()
    cases = [((chunk, h, w, c), k, torch.bfloat16, n, 0) for (k, c, h, w), n in b7.items()]
    cases += [((chunk, 26, 40, 960), 5, torch.float32, 0, 0)]
    # the kernel's other paths: C not a multiple of 8 (scalar channels), W
    # shorter than a thread's run, H = 1, an x off 16-byte alignment
    for dtype in (torch.float32, torch.bfloat16):
        cases += [((3, 13, 7, 40), 5, dtype, 0, 0), ((3, 9, 11, 36), 3, dtype, 0, 0), ((3, 9, 11, 36), 5, dtype, 0, 0),
                  ((2, 6, 3, 64), 3, dtype, 0, 0), ((2, 6, 3, 64), 5, dtype, 0, 0), ((2, 1, 17, 40), 3, dtype, 0, 0),
                  ((2, 1, 17, 40), 5, dtype, 0, 0), ((2, 9, 12, 64), 3, dtype, 0, 1)]
    worst = 0.0
    for shape, k, dtype, n_blocks, offset in cases:
        x, wt, a, bias = _dw_inputs(shape, k, dtype, gen, offset)
        pl = dw.plan(tuple(x.shape), k, x.element_size(), x.data_ptr() % 16 == 0)
        y_k = dw._kernel_fwd(x, wt, a, bias, k)
        y_p = dw.dw_conv_bn_silu_plain(x, wt, a, bias, k)
        torch.cuda.synchronize()
        ok, err = dw.within_tolerance(y_k, y_p)
        equal = (y_k == y_p).float().mean().item()
        scale = y_p.float().abs().max().item()
        if not ok:
            raise AssertionError(f"dw_conv_bn_silu kernel vs plain out of tolerance at {shape} k{k} {dtype} "
                                 f"({pl}): max_abs_err {err}, max|y| {scale}, equal {equal:.6f}")
        worst = max(worst, err)
        where = f"{n_blocks} B7 blocks" if n_blocks else ("x off 16-byte alignment" if offset else "extra case")
        _log("kernels", f"dw {shape} k{k} {str(dtype)[6:]} ({where}; vec {pl.vec}, {pl.blocks} blocks of "
             f"{pl.threads} threads, {pl.smem} B shared): max_abs_err {err:.3g} (max|y| {scale:.3g}), "
             f"{100 * equal:.4f}% equal, within tolerance")
        del x, wt, a, bias, y_k, y_p

    # every B7 shape of a chunk, in turns with cuDNN's grouped conv (the
    # conv alone, without BN + SiLU); the plain version at the costliest
    sums = {"kernel": 0.0, "library": 0.0, "bound": 0.0, "kernel_device": 0.0, "library_device": 0.0}
    for (k, c, h, w), n in b7.items():
        x, wt, a, bias = _dw_inputs((chunk, h, w, c), k, torch.bfloat16, gen)
        fns = {"kernel": lambda: dw._kernel_fwd(x, wt, a, bias, k),
               "library": lambda: torch.nn.functional.conv2d(x, wt, padding=k // 2, groups=c)}
        dev = {key: _device_ms(fn) for key, fn in fns.items()}  # before the plain version joins
        if (k, c, h, w) == (3, 288, 104, 160):
            fns["plain"] = lambda: dw.dw_conv_bn_silu_plain(x, wt, a, bias, k)
        t = _turns(fns)
        bound = _bound(_nbytes(x, x, wt, a, bias), 2 * k * k * x.numel())
        for key, v in (("kernel", t["kernel"]), ("library", t["library"]), ("bound", bound[0]),
                       ("kernel_device", dev["kernel"]), ("library_device", dev["library"])):
            sums[key] += n * v
        _log("kernels", f"dw ({chunk},{h},{w},{c}) k{k} bf16 x {n} blocks/forward, ms/call on {card}: kernel "
             f"{t['kernel']:.4f} (device {dev['kernel']:.4f}), F.conv2d(groups=C) {t['library']:.4f} "
             f"(device {dev['library']:.4f})" + (f", plain {t['plain']:.4f}" if "plain" in t else "")
             + f", bound {bound[0]:.4f} ({100 * bound[0] / dev['kernel']:.1f}% of it in device time); "
             f"{2 * _nbytes(x) / dev['kernel'] / 1e9:.2f} TB/s of x read once + y written once")
        if "plain" in t:
            ms = {**t, "bound": bound}
        del x, wt, a, bias
    _log("kernels", f"dw per B7 forward at chunk {chunk} (sum of blocks x ms): CUDA events: kernel "
         f"{sums['kernel']:.4f} ms, F.conv2d(groups=C) {sums['library']:.4f} ms; device time: kernel "
         f"{sums['kernel_device']:.4f} ms, F.conv2d(groups=C) {sums['library_device']:.4f} ms; bound "
         f"{sums['bound']:.4f} ms ({100 * sums['bound'] / sums['kernel_device']:.1f}% of the kernel's device time)")

    agree = _b7_card_vs_cpu()
    _log("kernels", f"B7 U-Net on the card (the kernel, f32, no TF32) vs the port's CPU path (the "
         f"plain version) at (2,48,64,1): logits max rel err {agree['logit_err']:.3g}, "
         f"labels {100 * agree['labels_equal']:.2f}% equal, classes {agree['classes']}")

    # B7 is differentiable: the Function's gradient at one B7 shape per k
    for (k, c, h, w) in ((3, 288, 104, 160), (5, 480, 52, 80)):
        for dtype in (torch.float32, torch.bfloat16):
            e = _dw_grad_check((4, h, w, c), k, dtype, gen)
            _log("kernels", f"dw gradient (4,{h},{w},{c}) k{k} {str(dtype)[6:]}: the Function (kernel forward, "
                 f"plain f32 backward) vs autograd through the plain version, worst of dx, dw, da, db "
                 f"{e:.3g} of the largest gradient (bound {1e-5 if dtype == torch.float32 else 1e-2:g})")

    # one B7 U-Net apply (flip TTA) on a chunk of full frames launches the kernel 102 times
    params = EfficientNet.init(torch.Generator().manual_seed(SEED), device="cuda")
    frames = torch.rand((chunk, 400, 640, 1), generator=gen, device="cuda")

    def apply():
        with torch.no_grad():
            return EfficientNet.apply(params, frames, compute_dtype=torch.bfloat16)

    apply()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = dw.LAUNCHES["dw_conv_bn_silu"]
    ev, tries = _trace(apply, lambda ev: any("dw_conv_bn_silu_kernel" in e.key for e in ev),
                       "dw_conv_bn_silu_kernel in one B7 U-Net apply")
    launched = (dw.LAUNCHES["dw_conv_bn_silu"] - before) / tries
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    events = [e for e in ev if "dw_conv_bn_silu_kernel" in e.key]
    traced = sum(e.count for e in events)
    if launched != 102:
        raise AssertionError(f"one B7 apply: dw_conv_bn_silu_kernel traced {traced} times, counted "
                             f"{launched} launches; 102 expected")
    dw_us = sum(getattr(e, "self_device_time_total", 0) for e in events)
    all_us = sum(getattr(e, "self_device_time_total", 0) for e in _device_events(ev))
    apply_ms = min(_time_ms(apply, iters=3) for _ in range(2))
    _log("kernels", f"profiler: dw_conv_bn_silu_kernel traced {traced} times in one B7 U-Net apply at "
         f"({chunk},400,640,1) bf16 TTA ({dw_us / 1000:.3f} ms of {all_us / 1000:.3f} ms device time); "
         f"apply {apply_ms:.2f} ms; peak memory {peak_gb:.2f} GB on {card}")
    return {"err": worst, "ms": ms["kernel"], "plain_ms": ms["plain"], "library_ms": ms["library"],
            "bound": ms["bound"], "b7_apply_ms": apply_ms, "b7_peak_gb": peak_gb}


def _stats_inputs(shape, dtype, gen):
    """x with planted zeros and negatives (so the x > 0 mask and the relu
    both bite), and the three cotangents."""
    import torch

    b, c, h, w = shape
    x = torch.randn((b, h, w, c), generator=gen, device="cuda")
    x[:, 0:2, 0:2, :] = 0.0
    x[:, 2:4, 0:2, :] = -1.5
    x = x.to(dtype).permute(0, 3, 1, 2)
    ct = torch.randn((b, h, w, c), generator=gen, device="cuda").to(dtype).permute(0, 3, 1, 2)
    a = torch.randn((b, c), generator=gen, device="cuda")
    b2 = torch.randn((b, c), generator=gen, device="cuda") * 0.1
    return x, ct, a, b2


def phase_kernels_relu_stats(card: str):
    """relu_stats fwd/bwd against the plain versions at the 2019 tap shapes
    and more: y and g bit-exact, s1/s2 within the stated tolerance."""
    import torch
    from iris_style_transfer_tpu_torch.ops import relu_stats as rs

    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    cases = [(sh, torch.bfloat16) for sh in TAPS_2019 + ((128, 64, 224, 224),)]
    cases += [((8, 64, 56, 56), torch.float32), ((3, 5, 7, 9), torch.float32), ((3, 5, 7, 9), torch.bfloat16)]
    worst = {"fwd": 0.0, "bwd": 0.0}
    for shape, dtype in cases:
        x, ct, a, b2 = _stats_inputs(shape, dtype, gen)
        y_k, s1_k, s2_k = rs._kernel_fwd(x)
        y_p, s1_p, s2_p = rs.relu_stats_fwd_plain(x)
        g_k = rs._kernel_bwd(x, ct, a, b2)
        g_p = rs.relu_stats_bwd_plain(x, ct, a, b2)
        torch.cuda.synchronize()
        ok1, e1 = rs.sums_within_tolerance(s1_k, s1_p)
        ok2, e2 = rs.sums_within_tolerance(s2_k, s2_p)
        e_y = (y_k.float() - y_p.float()).abs().max().item()
        e_g = (g_k.float() - g_p.float()).abs().max().item()
        if not (torch.equal(y_k, y_p) and torch.equal(g_k, g_p) and ok1 and ok2):
            raise AssertionError(f"relu_stats kernel vs plain at {shape} {dtype}: y err {e_y} (equal "
                                 f"{torch.equal(y_k, y_p)}), g err {e_g} (equal {torch.equal(g_k, g_p)}), "
                                 f"s1 err {e1} ({ok1}), s2 err {e2} ({ok2})")
        n_masked = int((x <= 0).sum())
        worst["fwd"] = max(worst["fwd"], e1, e2, e_y)
        worst["bwd"] = max(worst["bwd"], e_g)
        _log("kernels", f"relu_stats {shape} {str(dtype)[6:]}: y and g bit-exact vs plain (max_abs_err {e_y:.3g}, "
             f"{e_g:.3g}; {n_masked} elements <= 0); s1 max_abs_err {e1:.3g} (max s1 {s1_p.max().item():.4g}), "
             f"s2 {e2:.3g} (max s2 {s2_p.max().item():.4g}), within 1e-5 * sum|terms|")
        del x, ct, a, b2, y_k, y_p, g_k, g_p

    x, ct, a, b2 = _stats_inputs(TAPS_2019[0], torch.bfloat16, gen)
    ms = _turns({"fwd_plain": lambda: rs.relu_stats_fwd_plain(x), "fwd": lambda: rs._kernel_fwd(x),
                 "bwd_plain": lambda: rs.relu_stats_bwd_plain(x, ct, a, b2),
                 "bwd": lambda: rs._kernel_bwd(x, ct, a, b2)})
    ms["bound_fwd"] = _bound(_nbytes(x, x, a, a))  # x read; y, s1 and s2 written
    ms["bound_bwd"] = _bound(_nbytes(x, ct, a, b2, x))
    gb = x.numel() * x.element_size() / 1e9
    _log("kernels", f"relu_stats (64,64,224,224) bf16 ms/call on {card}: fwd {ms['fwd']:.4f} (plain "
         f"{ms['fwd_plain']:.4f}, bound {ms['bound_fwd'][0]:.4f}; {2 * gb / ms['fwd']:.2f} TB/s of x read + y "
         f"written), bwd {ms['bwd']:.4f} (plain {ms['bwd_plain']:.4f}, bound {ms['bound_bwd'][0]:.4f}; "
         f"{3 * gb / ms['bwd']:.2f} TB/s of x, ct read + g written)")
    del x, ct, a, b2

    # the path launches them: one VGG19 forward+backward with stats taps
    from iris_style_transfer_tpu_torch.models import VGG19

    params = VGG19.init(torch.Generator().manual_seed(SEED), device="cuda")
    img = torch.rand((64, 3, 224, 224), generator=gen, device="cuda").requires_grad_(True)

    def fwd_bwd():
        _, c, st = VGG19.apply(params, img, compute_dtype=torch.bfloat16, truncate=True, stats_taps=True)
        loss = c[0].float().square().mean() + sum(m.sum() + sd.sum() for m, sd in st)
        torch.autograd.grad(loss, img)

    fwd_bwd()
    torch.cuda.synchronize()
    before = dict(rs.LAUNCHES)
    ev, tries = _trace(fwd_bwd, lambda ev: all(any(f"{k}_kernel" in e.key for e in ev) for k in before),
                       "relu_stats_fwd_kernel and relu_stats_bwd_kernel in one VGG19 fwd+bwd with stats taps")
    counted = {k: (rs.LAUNCHES[k] - before[k]) / tries for k in before}
    traced = {k: sum(e.count for e in ev if f"{k}_kernel" in e.key) for k in before}
    if counted != {"relu_stats_fwd": 4, "relu_stats_bwd": 4}:
        raise AssertionError(f"one VGG19 fwd+bwd with stats taps counted {counted} launches and traced {traced} "
                             "kernels; 4 launches of each, each traced, expected")
    # the profiler has traced fewer relu_stats_fwd kernels than were launched;
    # every relu_stats event it keeps is listed, for the record
    keys = {e.key[:60]: e.count for e in ev if "relu_stats" in e.key}
    _log("kernels", f"one VGG19 fwd+bwd with stats taps at (64,3,224,224) bf16: {counted} launches counted, "
         f"profiler traced {traced}; its relu_stats events {keys}")
    return {"err_fwd": worst["fwd"], "err_bwd": worst["bwd"], **ms}


def phase_kernels_gram(card: str):
    """The Gram kernels against an f64 Gram and the plain bmm (TF32 off) at
    the eight style-tap shapes and odd ones, on both kernels; each tap timed
    against the plain version and bf16 torch.bmm, with its bound; a profiler
    proof that a Gram-loss closure launches the tensor-core kernel and an
    f32 Gram the CUDA-core one."""
    import torch
    from iris_style_transfer_tpu_torch.ops import blockwise_gram as bg

    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    n_sm = bg._n_sm(0)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cases = [(sh, torch.bfloat16) for sh in TAPS_512 + TAPS_2019]
        cases += [((4, 512, 64, 64), torch.float32), ((2, 130, 9, 7), torch.float32),
                  ((3, 5, 7, 9), torch.bfloat16), ((2, 130, 9, 7), torch.bfloat16),  # C % 8 != 0: CUDA cores
                  ((3, 24, 7, 9), torch.bfloat16), ((2, 136, 9, 7), torch.bfloat16),  # HW, C off the tiles
                  ((1, 8, 1, 1), torch.bfloat16)]
        worst = 0.0
        for shape, dtype in cases:
            b, c, h, w = shape
            x = torch.relu(torch.randn((b, h, w, c), generator=gen, device="cuda")).to(dtype).permute(0, 3, 1, 2)
            pl = bg.plan(shape, dtype, x.data_ptr() % 16 == 0, n_sm)
            g_k = bg._kernel_gram(x)
            g_p = bg.gram_matrix_plain(x)
            g64 = bg.gram_f64(x)
            torch.cuda.synchronize()
            # the f64 Gram is the tight witness, the TF32-off bmm the second one
            ok64, e_k = bg.within_f64_tolerance(g_k, g64)
            ok, err = bg.within_tolerance(g_k, g_p)
            e_p = bg.within_f64_tolerance(g_p, g64)[1]
            scale = g64.abs().max().item()
            if not (ok64 and ok and torch.equal(g_k, g_k.transpose(1, 2))):
                raise AssertionError(f"gram kernel out of tolerance at {shape} {dtype} ({pl.kernel}): vs f64 {e_k} "
                                     f"(bound 1e-5 * {scale}), vs plain {err} (bound 1e-4 * max|G|), or not symmetric")
            worst = max(worst, err)
            _log("kernels", f"gram {shape} {str(dtype)[6:]} on gram_{pl.kernel}_kernel (wg {pl.wg}, {pl.splits} "
                 f"splits of {pl.chunk} px, {pl.items} items on {pl.blocks} blocks): vs f64 max_abs_err {e_k:.3g} "
                 f"({e_k / scale:.3g} of max|G| {scale:.4g}, within 1e-5); vs plain {err:.3g} ({err / scale:.3g}, "
                 f"within 1e-4); plain vs f64 {e_p / scale:.3g}; symmetric")
            del x, g_k, g_p, g64
        ms = {}
        for shape in TAPS_512 + TAPS_2019:
            b, c, h, w = shape
            x = torch.relu(torch.randn((b, h, w, c), generator=gen, device="cuda")).to(torch.bfloat16)
            xf = x.reshape(b, h * w, c)  # the NHWC bytes as (B, HW, C), for the library bmm
            x = x.permute(0, 3, 1, 2)
            t = _turns({"plain": lambda: bg.gram_matrix_plain(x), "kernel": lambda: bg._kernel_gram(x),
                        "library": lambda: torch.bmm(xf.transpose(1, 2), xf)})
            # device time too: where a call is short, events hold the wrapper's host time
            t["kernel_device"] = _device_ms(lambda: bg._kernel_gram(x))
            t["library_device"] = _device_ms(lambda: torch.bmm(xf.transpose(1, 2), xf))
            gflop = 2 * b * h * w * c * c / 1e9
            t["bound"] = _bound(_nbytes(x) + b * c * c * 4, gflop * 1e9)
            _log("kernels", f"gram {shape} bf16 ms/call on {card}: kernel {t['kernel']:.4f} (device "
                 f"{t['kernel_device']:.4f}; plain {t['plain']:.4f}, bf16 torch.bmm {t['library']:.4f}, device "
                 f"{t['library_device']:.4f}; bound {t['bound'][0]:.4f} by {t['bound'][1]}, "
                 f"{100 * t['bound'][0] / t['kernel_device']:.1f}% of it in device time); "
                 f"{gflop / t['kernel_device']:.2f} TFLOP/s of the {gflop:.2f} GFLOP contraction in device time "
                 f"(bmm {gflop / t['library_device']:.2f}); {_nbytes(x) / t['kernel_device'] / 1e9:.2f} TB/s of x")
            ms[shape] = t
            del x, xf
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32

    # the path launches the tensor-core kernel: one Gram-loss closure at
    # (4, 3, 512, 512) bf16; an f32 Gram launches the CUDA-core one
    from iris_style_transfer_tpu_torch.models import VGG19
    from iris_style_transfer_tpu_torch.ops.losses import style_loss_gram

    params = VGG19.cast(VGG19.init(torch.Generator().manual_seed(SEED), device="cuda"), torch.bfloat16)
    s_img = torch.rand((4, 3, 512, 512), generator=gen, device="cuda")
    img = torch.rand((4, 3, 512, 512), generator=gen, device="cuda").requires_grad_(True)
    with torch.no_grad():
        targets = [bg.gram_matrix(f) for f in VGG19.apply(params, s_img, compute_dtype=torch.bfloat16,
                                                          truncate=True)[2]]

    def closure():
        _, _, st = VGG19.apply(params, img, compute_dtype=torch.bfloat16, truncate=True)
        torch.autograd.grad(style_loss_gram(st, targets, gram_fn=bg.gram_matrix), img)

    xf32 = torch.rand((4, 64, 64, 512), generator=gen, device="cuda").permute(0, 3, 1, 2)
    closure()
    bg._kernel_gram(xf32)
    torch.cuda.synchronize()
    traced = {}
    def f32_grams():  # three calls: the profiler has missed single launches here
        for _ in range(3):
            bg._kernel_gram(xf32)

    for name, fn, want, kernel in (("closure", closure, 4, "gram_tc_kernel"), ("f32", f32_grams, 3, "gram_fma_kernel")):
        before = bg.LAUNCHES["gram_matrix"]
        ev, tries = _trace(fn, lambda ev: any(kernel in e.key for e in ev), f"{kernel} in the {name} Grams")
        counted = (bg.LAUNCHES["gram_matrix"] - before) / tries
        traced[name] = {k: sum(e.count for e in ev if f"gram_{k}_kernel" in e.key) for k in ("tc", "fma")}
        if counted != want:
            raise AssertionError(f"{name}: counted {counted} gram launches; {want} expected")
    if not (traced["closure"]["tc"] and not traced["closure"]["fma"] and traced["f32"]["fma"]
            and not traced["f32"]["tc"]):
        raise AssertionError(f"the profiler traced {traced}: a bf16 Gram-loss closure must launch gram_tc_kernel "
                             "only, an f32 Gram gram_fma_kernel only")
    _log("kernels", f"one Gram-loss closure at (4,3,512,512) bf16: 4 gram launches counted, profiler traced "
         f"gram_tc_kernel {traced['closure']['tc']} times and gram_fma_kernel 0; three f32 Grams at (4,512,64,64) "
         f"traced gram_fma_kernel {traced['f32']['fma']} time(s) and gram_tc_kernel 0")
    return {"err": worst, "ms": ms[TAPS_512[0]]["kernel"], "plain_ms": ms[TAPS_512[0]]["plain"],
            "library_ms": ms[TAPS_512[0]]["library"], "bound": ms[TAPS_512[0]]["bound"], "taps": ms}


def _conv1_inputs(shape, cout, dtype, gen):
    import torch

    b, cin, h, w = shape
    x = torch.rand((b, h, w, cin), generator=gen, device="cuda").to(dtype).permute(0, 3, 1, 2)
    wt = torch.randn((cout, cin, 3, 3), generator=gen, device="cuda") * 0.3
    bias = torch.randn(cout, generator=gen, device="cuda")
    return x, wt, bias


def phase_kernels_conv1(card: str):
    """conv1 against its plain version (and, in f32, an f64 conv) at the
    main paths' shapes and odd ones; timing against cuDNN's F.conv2d; and
    one launch per VGG19 pass under the profiler."""
    import torch
    import torch.nn.functional as F
    from iris_style_transfer_tpu_torch.models import VGG19
    from iris_style_transfer_tpu_torch.ops import conv1 as c1

    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    cases = [((64, 3, 224, 224), 64, torch.bfloat16, "2019 NST, main and trainer at bs 64"),
             ((4, 3, 512, 512), 64, torch.bfloat16, "the Gram demo"),
             ((3, 3, 37, 53), 64, torch.float32, "odd"), ((3, 1, 13, 29), 64, torch.bfloat16, "C_in 1"),
             ((3, 1, 13, 29), 64, torch.float32, "C_in 1"), ((3, 4, 13, 29), 64, torch.float32, "C_in 4"),
             ((3, 4, 13, 29), 64, torch.bfloat16, "C_in 4"), ((3, 4, 13, 29), 40, torch.bfloat16, "C_in 4, C_out 40"),
             ((2, 3, 17, 45), 60, torch.bfloat16, "C_out 60, H and W off the 16x32 tile"),
             ((2, 3, 17, 45), 60, torch.float32, "C_out 60, H and W off the tile"),
             ((2, 2, 9, 70), 128, torch.bfloat16, "C_in 2, C_out 128: two chunks of 64")]
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    worst = 0.0
    try:
        for shape, cout, dtype, what in cases:
            x, wt, bias = _conv1_inputs(shape, cout, dtype, gen)
            y_k = c1._kernel_fwd(x, wt, bias)
            y_p = c1.conv1_fwd_plain(x, wt, bias)
            y_lib = F.conv2d(x, wt.to(dtype), bias.to(dtype), padding=1)  # cuDNN, bias in the input dtype
            torch.cuda.synchronize()
            ok, err = c1.within_tolerance(y_k, y_p)
            scale = y_p.float().abs().max().item()
            equal = (y_k == y_p).float().mean().item()
            msg = f"max_abs_err {err:.3g} (max|y| {scale:.4g}), {100 * equal:.4f}% equal"
            if dtype == torch.float32:
                y64 = F.conv2d(x.double(), wt.double(), bias.double(), padding=1)
                e64 = (y_k.double() - y64).abs().max().item()
                ok = ok and e64 <= 1e-5 * scale
                msg += f"; vs f64 {e64:.3g} (bound {1e-5 * scale:.3g})"
            else:
                msg += f"; cuDNN bf16 F.conv2d equals the kernel on {100 * (y_k == y_lib).float().mean().item():.2f}%"
            if not ok:
                raise AssertionError(f"conv1 kernel out of tolerance at {shape} -> {cout} {dtype}: {msg}")
            worst = max(worst, err)
            _log("kernels", f"conv1 {shape}->{cout} {str(dtype)[6:]} ({what}): {msg}, within tolerance")
            del x, wt, bias, y_k, y_p, y_lib
    finally:
        torch.backends.cudnn.allow_tf32 = tf32

    timed = {}
    for shape in ((64, 3, 224, 224), (4, 3, 512, 512)):
        x, wt, bias = _conv1_inputs(shape, 64, torch.bfloat16, gen)
        w16, b16 = wt.to(torch.bfloat16), bias.to(torch.bfloat16)
        t = _turns({"plain": lambda: c1.conv1_fwd_plain(x, wt, bias), "kernel": lambda: c1._kernel_fwd(x, wt, bias),
                    "library": lambda: F.conv2d(x, w16, b16, padding=1)})
        y = c1._kernel_fwd(x, wt, bias)
        flops = 2 * y.numel() * 9 * x.shape[1]
        t["bound"] = _bound(_nbytes(x, y, w16, b16), flops)
        _log("kernels", f"conv1 {shape}->64 bf16 ms/call on {card}: kernel {t['kernel']:.4f} (plain "
             f"{t['plain']:.4f}, cuDNN F.conv2d {t['library']:.4f}); bound {t['bound'][0]:.4f} ms by "
             f"{t['bound'][1]} ({100 * t['bound'][0] / t['kernel']:.1f}% of it; {flops / 1e9:.2f} GFLOP, "
             f"{flops / PEAK_FLOPS['bf16'] * 1e3:.4f} ms on the bf16 tensor cores); "
             f"{_nbytes(x, y) / t['kernel'] / 1e9:.2f} TB/s")
        timed[shape] = t
        del x, wt, bias, y
    ms = timed[(64, 3, 224, 224)]

    params = VGG19.init(torch.Generator().manual_seed(SEED), device="cuda")
    img = torch.rand((64, 3, 224, 224), generator=gen, device="cuda")
    with torch.no_grad():
        VGG19.apply(params, img, compute_dtype=torch.bfloat16)
        torch.cuda.synchronize()
        before = c1.LAUNCHES["conv1"]
        # three passes: the profiler has missed single launches here; bf16 takes the tensor-core kernel
        ev, tries = _trace(lambda: [VGG19.apply(params, img, compute_dtype=torch.bfloat16) for _ in range(3)],
                           lambda ev: any("conv1_mma_kernel" in e.key for e in ev),
                           "conv1_mma_kernel in three VGG19 forwards")
    traced = sum(e.count for e in ev if "conv1_mma_kernel" in e.key)
    counted = (c1.LAUNCHES["conv1"] - before) / tries
    if counted != 3:
        raise AssertionError(f"three VGG19 passes traced conv1_mma_kernel {traced} times, counted "
                             f"{counted} launches a trace; 3 launches (one a pass), traced, expected")
    _log("kernels", f"three VGG19 forwards at (64,3,224,224) bf16: 3 conv1 launches counted, profiler traced "
         f"conv1_mma_kernel {traced} time(s)")
    return {"err": worst, "ms": ms["kernel"], "plain_ms": ms["plain"], "library_ms": ms["library"],
            "bound": ms["bound"]}


CC_FRAMES, CC_H, CC_W = 64, 400, 640  # the 2019 main's batch at the frames' full size
CC_AREA = 500  # mask_and_crop_iris's default area_threshold
CC_ESTIMATOR_BS = 8
# crops, card against CPU: one float32 ulp of a sample coordinate in [512, 1024)
# (the card contracts crop_and_resize's (i + 0.5) * scale - 0.5 + r_min into
# FMAs, moving a coordinate by an ulp and a bilinear weight by as much)
CROP_TOL = 512 * 1.1920929e-07


def _serpentine(h: int, w: int):
    """Full rows 0, 2, 4, ... joined at alternating ends: one component
    whose path runs through every row (128k pixels long at 400x640)."""
    import torch

    m = torch.zeros((1, h, w), dtype=torch.bool)
    m[:, 0::2] = True
    for k, y in enumerate(range(1, h, 2)):
        m[0, y, w - 1 if k % 2 == 0 else 0] = True
    return m


def _seam_masks(b: int, h: int, w: int) -> list:
    """Masks on the card whose components cross the kernel's tile seams:
    one-pixel stripes on both sides of every seam, and a checkerboard."""
    import torch
    from iris_style_transfer_tpu_torch.ops import connected as cc

    m = torch.zeros((h, w), dtype=torch.bool)
    for y in range(cc.TILE_H, h, cc.TILE_H):
        m[y - 1, 1::3] = m[y, ::2] = True
    for x in range(cc.TILE_W, w, cc.TILE_W):
        m[::2, x - 1] = m[1::3, x] = True
    board = (torch.arange(h)[:, None] + torch.arange(w)[None, :]) % 2 == 0
    return [("seam stripes", m.expand(b, h, w).contiguous().cuda()),
            ("checkerboard", board.expand(b, h, w).contiguous().cuda())]


def phase_connected(card: str) -> dict:
    """The union-find labelling (``ops/csrc/connected.cu``: tile, seam,
    finalize) against its plain version on the card, labels and the fused
    per-label areas bit-exact at both connectivities: RITnet's iris masks of
    64 twin frames, seeded noise at 0.3, 0.45 and 0.6, a serpentine,
    all-false and all-true, B = 1 and 64, ragged tiles ((64, 401, 639),
    (3, 1, 640), (3, 400, 1)), stripes on the tile seams and a
    checkerboard; the tie rule of largest_component; then the paths that
    wait on it at full width, each against the port's CPU path:
    mask_and_crop_iris(use_area_opening=True) at bs 64,
    extract_eye_landmarks(select_largest=True) on RITnet's segmentations,
    GazeEstimator1Complicated at bs 8; launches counted over those paths;
    the kernel's time, labels only and with areas, against the plain
    version's and the two bounds, and largest_component and area_opening
    end to end."""
    import torch
    from iris_style_transfer_tpu_torch.data import synthetic_eye_batch
    from iris_style_transfer_tpu_torch.models import GazeEstimator1Complicated, RITnet
    from iris_style_transfer_tpu_torch.ops import connected as cc
    from iris_style_transfer_tpu_torch.ops.ellipse import extract_eye_landmarks
    from iris_style_transfer_tpu_torch.pipelines.iris import extract_iris_batch, iris_mask_from_seg, mask_and_crop_iris

    t_phase = time.perf_counter()
    frames_cpu = torch.from_numpy(synthetic_eye_batch(CC_FRAMES, CC_H, CC_W, seed=SEED + 9)[0])
    frames = frames_cpu.cuda()
    ritnet = RITnet.pretrained(device="cuda")
    deterministic, tf32 = torch.backends.cudnn.deterministic, torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.deterministic, torch.backends.cudnn.allow_tf32 = True, False  # RITnet twice, same labels
    try:
        with torch.no_grad():
            seg = RITnet.apply(ritnet, frames)
        iris = iris_mask_from_seg(seg, frames)[..., 0]
        gen = torch.Generator(device="cuda").manual_seed(SEED + 10)
        full = (CC_FRAMES, CC_H, CC_W)
        cases = [("RITnet iris masks", iris), ("RITnet iris masks, B = 1", iris[:1])]
        cases += [(f"noise {d}", torch.rand(full, generator=gen, device="cuda") < d) for d in (0.3, 0.45, 0.6)]
        cases += [("serpentine", _serpentine(CC_H, CC_W).cuda()),
                  ("all false", torch.zeros(full, dtype=torch.bool, device="cuda")),
                  ("all true", torch.ones(full, dtype=torch.bool, device="cuda"))]
        cases += [("ragged tiles, noise 0.45", torch.rand(shape, generator=gen, device="cuda") < 0.45)
                  for shape in ((CC_FRAMES, CC_H + 1, CC_W - 1), (3, 1, CC_W), (3, CC_H, 1))]
        cases += _seam_masks(4, CC_H, CC_W)
        err = 0
        for what, m in cases:
            for conn in (1, 2):
                lab_k = cc.connected_components(m, conn)
                lab_a, areas_k = cc.connected_components_with_areas(m, conn)
                lab_p = cc.connected_components_plain(m, conn)
                areas_p = cc._areas(lab_p)
                torch.cuda.synchronize()
                err = max(err, int((lab_k - lab_p).abs().max()), int((lab_a - lab_p).abs().max()),
                          int((areas_k - areas_p).abs().max()))
                if not (torch.equal(lab_k, lab_p) and torch.equal(lab_a, lab_p) and torch.equal(areas_k, areas_p)):
                    bad = int((lab_k != lab_p).sum()), int((lab_a != lab_p).sum()), int((areas_k != areas_p).sum())
                    raise AssertionError(f"connected_components kernel != plain on {what} {tuple(m.shape)}, "
                                         f"connectivity {conn}: {bad[0]} labels, {bad[1]} labels of the area call "
                                         f"and {bad[2]} areas differ")
                roots = torch.arange(1, m[0].numel() + 1, device="cuda").view(m.shape[1:])
                n = int((lab_k == roots).sum())  # a component's root pixel carries its own index + 1
                _log("connected", f"{what} {tuple(m.shape)} connectivity {conn}: labels and areas bit-exact, "
                     f"{n} components, largest {int(areas_k[:, 1:].max()) if areas_k.numel() > 1 else 0} pixels")
        two = torch.zeros((1, 20, 24), dtype=torch.bool, device="cuda")
        two[0, 2:6, 15:19] = True
        two[0, 10:14, 3:7] = True
        tie = cc.largest_component(two)
        if not (torch.equal(tie.cpu(), cc.largest_component(two.cpu())) and bool(tie[0, 2:6, 15:19].all())
                and int(tie.sum()) == 16):
            raise AssertionError("largest_component on two equal squares does not keep the lower label")
        _log("connected", "largest_component on two equal squares keeps the lower label, as on the CPU")

        # the paths that wait on the labelling, launches counted over them
        est_params = GazeEstimator1Complicated.init(torch.Generator().manual_seed(SEED))
        est_params_dev = _to_device(est_params, "cuda")
        cc.LAUNCHES["connected_components"] = 0
        with torch.no_grad():
            ir, masks, bboxes = mask_and_crop_iris(frames, ritnet, area_threshold=CC_AREA, use_area_opening=True)
            lms = extract_eye_landmarks(seg, select_largest=True)
            gz = GazeEstimator1Complicated.apply(est_params_dev, seg[:CC_ESTIMATOR_BS], extract_feature=True)
        torch.cuda.synchronize()
        launches = cc.LAUNCHES["connected_components"]
        want = 3 * cc.KERNELS_PER_CALL  # the opening, then the pupil and the iris of the landmarks
        if launches != want:
            raise AssertionError(f"the area-opening and landmark paths launched the labelling {launches} times, "
                                 f"{want} expected")
        seg_cpu = seg.cpu()
        ir_c, masks_c, bboxes_c = extract_iris_batch(frames_cpu, seg_cpu, open_area=CC_AREA)
        err_ir = (ir.cpu() - ir_c).abs().max().item()
        lms_c = extract_eye_landmarks(seg_cpu, select_largest=True)
        err_lm = ((lms.cpu() - lms_c).abs() / (lms_c.abs() + 1.0)).max().item()
        gz_c = GazeEstimator1Complicated.apply(est_params, seg_cpu[:CC_ESTIMATOR_BS], extract_feature=True)
        err_gz = (gz.cpu() - gz_c).abs().max().item()
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.allow_tf32 = deterministic, tf32
    removed = int(iris.sum()) - int(masks.sum())
    same = torch.equal(masks.cpu(), masks_c) and torch.equal(bboxes.cpu(), bboxes_c)
    _log("connected", f"mask_and_crop_iris(use_area_opening=True, area {CC_AREA}) at {full}: masks and bboxes "
         f"{'equal to' if same else 'DIFFER from'} the CPU path's, crops {err_ir:.3g} (tolerance {CROP_TOL:.3g}); "
         f"the opening removed {removed} of {int(iris.sum())} iris pixels; extract_eye_landmarks("
         f"select_largest=True): {err_lm:.3g} relative to the CPU path (|d| / (|cpu| + 1), tolerance 1e-4); "
         f"GazeEstimator1Complicated bs {CC_ESTIMATOR_BS}: {err_gz:.3g} (tolerance 1e-4); {launches} labelling "
         f"launches (3 calls x {cc.KERNELS_PER_CALL} kernels)")
    if not (same and err_ir <= CROP_TOL and err_lm <= 1e-4 and err_gz <= 1e-4 and bool(torch.isfinite(lms).all())
            and gz.shape == (CC_ESTIMATOR_BS, 3)):
        raise AssertionError("the area-opening, landmark or complicated-estimator path on the card differs from "
                             "the CPU path beyond its tolerance (see the line above)")

    timed = {}
    for what, m in [("RITnet iris masks", iris)] + [c for c in cases if c[0] in ("noise 0.45", "all true")]:
        for conn in (2, 1):
            lab, areas = cc.connected_components_with_areas(m, conn)
            t = _turns({"plain": lambda: cc.connected_components_plain(m, conn),
                        "kernel": lambda: cc.connected_components(m, conn),
                        "kernel with areas": lambda: cc.connected_components_with_areas(m, conn),
                        "largest_component": lambda: cc.largest_component(m, conn),
                        "area_opening": lambda: cc.area_opening(m, CC_AREA, conn)})
            t["bound"] = _bound(_nbytes(m, lab))
            t["bound areas"] = _bound(_nbytes(m, lab) + lab.numel() * 4)  # + each pixel's area entry written
            _log("connected", f"{what} {tuple(m.shape)} connectivity {conn} ms/call on {card}: kernel "
                 f"{t['kernel']:.4f} (plain {t['plain']:.4f}); bound {t['bound'][0]:.4f} ms by {t['bound'][1]} "
                 f"({100 * t['bound'][0] / t['kernel']:.1f}% of it); with areas {t['kernel with areas']:.4f}, bound "
                 f"{t['bound areas'][0]:.4f} ({100 * t['bound areas'][0] / t['kernel with areas']:.1f}%); "
                 f"largest_component {t['largest_component']:.4f}, area_opening {t['area_opening']:.4f}; "
                 "no library call computes it")
            timed[(what, conn)] = t
    ms = timed[("RITnet iris masks", 2)]
    _log("connected", f"phase took {time.perf_counter() - t_phase:.1f} s")
    return {"err": err, "ms": ms["kernel"], "plain_ms": ms["plain"], "bound": ms["bound"], "launches": launches,
            "ms_conn1": timed[("RITnet iris masks", 1)]["kernel"], "removed": removed}


def _nst_loop(make_kw: dict, shape, closures: int, seed: int):
    """The NST loop at ``shape`` on seeded VGG19 weights; one warm-up
    closure, then ``closures`` under ``set_sync_debug_mode("error")``.
    With a ``mesh`` in ``make_kw`` each rank draws the whole ``shape`` and
    keeps its block (``spatial_sharding``: its rows of the batch, and of
    H over a model group).  Returns (closures/s, c_hist, s_hist); fails
    unless finite and s_loss falls."""
    import torch
    from iris_style_transfer_tpu_torch.models import VGG19
    from iris_style_transfer_tpu_torch.ops import conv1 as c1
    from iris_style_transfer_tpu_torch.parallel import spatial_sharding
    from iris_style_transfer_tpu_torch.transfer.nst import make_nst_fn

    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = VGG19.init(torch.Generator().manual_seed(SEED), device="cuda")
    c = torch.rand(shape, generator=gen, device="cuda")
    s = torch.rand(shape, generator=gen, device="cuda")
    if make_kw.get("mesh") is not None:
        block = spatial_sharding(make_kw["mesh"], shape)
        c, s = c[block].contiguous(), s[block].contiguous()
    kw = dict(compute_dtype=torch.bfloat16, lbfgs_dtype=torch.bfloat16, history_size=10, **make_kw)
    make_nst_fn(epochs=1, **kw)(params, c, s)  # warm-up closure
    torch.cuda.synchronize()
    fn = make_nst_fn(epochs=closures, **kw)
    c1.LAUNCHES["conv1"] = 0
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        res = fn(params, c, s)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    if c1.LAUNCHES["conv1"] != closures + 2:  # the content and style targets, then one pass per closure
        raise AssertionError(f"NST {make_kw}: conv1 launched {c1.LAUNCHES['conv1']} times; {closures} + 2 expected")
    s_hist, c_hist = res.s_loss_hist.cpu(), res.c_loss_hist.cpu()
    if not (torch.isfinite(s_hist).all() and torch.isfinite(c_hist).all() and torch.isfinite(res.x).all()):
        raise AssertionError(f"NST {make_kw} loss history or image is not finite")
    if not s_hist[-1] < s_hist[0]:
        raise AssertionError(f"NST {make_kw}: s_loss did not fall: {s_hist[0].item()} -> {s_hist[-1].item()}")
    return closures / dt, c_hist, s_hist


def phase_nst(card: str, stats_taps: bool = False):
    rate, c_hist, s_hist = _nst_loop({"stats_taps": stats_taps}, (64, 3, 224, 224), NST_CLOSURES, SEED + 1)
    what = "stats taps" if stats_taps else "classic BN taps"
    _log("nst", f"{NST_CLOSURES} closures at (64,3,224,224) bf16 ({what}), no host sync: "
         f"{rate:.2f} closures/s, {64 * 60 * rate / 200:.1f} stylized images/min at 200 closures; "
         f"s_loss {s_hist[0].item():.6g} -> {s_hist[-1].item():.6g} on {card}")
    return rate, c_hist, s_hist


def _compare_histories(s_plain, s_stats) -> None:
    """The stats-tap NST against the classic one from the same start: the
    first closure sees the same image, so its s_loss differs only in the
    order of f32 sums; later closures follow L-BFGS steps whose bf16
    gradients may differ by an ulp here and there.  On an H100 the two
    agreed to 1.8e-7 at closure 0 and within 1e-5 over 200 closures, so
    every closure's ratio is held to 1e-3."""
    r = (s_stats / s_plain).double()
    first = abs(r[0].item() - 1)
    worst = (r - 1).abs().max().item()
    if not worst <= 1e-3:
        raise AssertionError(f"stats-tap NST s_loss vs classic: closure 0 off by {first:.3g}, worst closure "
                             f"{int((r - 1).abs().argmax())} off by {worst:.3g}, ratio range "
                             f"[{r.min().item():.4g}, {r.max().item():.4g}]")
    _log("nst", f"stats taps vs classic s_loss: closure 0 within {first:.3g}, closures 0-9 ratio "
         f"[{r[:10].min().item():.4g}, {r[:10].max().item():.4g}], all [{r.min().item():.4g}, "
         f"{r.max().item():.4g}], final {r[-1].item():.4g}")


def _gram_closure_split() -> dict:
    """One Gram-loss closure at (4, 3, 512, 512) bf16 on seeded VGG19
    weights: its wall time (10 closures on the host clock, synchronized),
    its device time and the Gram kernels' share of it (torch.profiler over
    5 closures), in ms.  Wall above device is time the card waits on the
    host.  Uses only names the port has had since its Gram kernel, so it
    measures an earlier tree's package as well."""
    import torch
    from iris_style_transfer_tpu_torch.models import VGG19
    from iris_style_transfer_tpu_torch.ops import blockwise_gram as bg
    from iris_style_transfer_tpu_torch.ops.losses import style_loss_gram

    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    params = VGG19.cast(VGG19.init(torch.Generator().manual_seed(SEED), device="cuda"), torch.bfloat16)
    img = torch.rand((4, 3, 512, 512), generator=gen, device="cuda").requires_grad_(True)
    with torch.no_grad():
        targets = [bg.gram_matrix(f) for f in VGG19.apply(params, img.detach(), compute_dtype=torch.bfloat16,
                                                          truncate=True)[2]]

    def closure():
        _, _, st = VGG19.apply(params, img, compute_dtype=torch.bfloat16, truncate=True)
        torch.autograd.grad(style_loss_gram(st, targets, gram_fn=bg.gram_matrix), img)

    for _ in range(3):
        closure()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        closure()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / 10 * 1e3
    ev, _ = _trace(lambda: [closure() for _ in range(5)], lambda ev: any("gram" in e.key for e in _device_events(ev)),
                   "the Gram kernels in five Gram-loss closures", cpu=False)
    device = sum(e.self_device_time_total for e in _device_events(ev)) / 5 / 1e3
    gram = sum(e.self_device_time_total for e in _device_events(ev) if "gram" in e.key) / 5 / 1e3
    return {"wall_ms": wall, "device_ms": device, "gram_device_ms": gram}


def phase_nst_gram(card: str):
    """The Gram-loss NST at bench.py's Gram secondary shape.  On seeded
    VGG19 weights the Gram loss is about 2.5e-7 at style weight 1, too
    small for an L-BFGS step to move a bf16 image; the style weight is the
    Gatys setting, 1e6.  Then one closure's wall and device time."""
    rate, _, s_hist = _nst_loop({"bn_loss": False, "s_loss_weight": GRAM_STYLE_WEIGHT}, (4, 3, 512, 512),
                                GRAM_NST_CLOSURES, SEED + 6)
    _log("nst_gram", f"{GRAM_NST_CLOSURES} Gram-loss closures at (4,3,512,512) bf16, style weight "
         f"{GRAM_STYLE_WEIGHT:g}, no host sync: "
         f"{rate:.2f} closures/s; s_loss {s_hist[0].item():.6g} -> {s_hist[-1].item():.6g} on {card}")
    split = _gram_closure_split()
    _log("nst_gram", f"one Gram-loss closure at (4,3,512,512) bf16: wall {split['wall_ms']:.3f} ms, device "
         f"{split['device_ms']:.3f} ms, of which the Gram kernels {split['gram_device_ms']:.3f} ms on {card}")
    return rate


def _reset(counters) -> None:
    for counts in counters:
        for k in counts:
            counts[k] = 0


def _run_main(wl, argv: list[str], counters: tuple[dict, ...], data_dir: str | None = None,
              arrays: dict | None = None):
    """``wl.main(argv)`` in a temporary directory, on the data tree under
    ``data_dir`` or on the synthetic twin, every count in ``counters`` set
    to 0 just before and read just after; also counts the NST calls.  With
    ``arrays``, every ``.npy`` file the main wrote is loaded into it by
    name.  Returns (results, launches, nst_calls, wall seconds)."""
    import numpy as np
    import torch

    real, calls = wl.cached_nst_program, [0]

    def counting(*args):
        fn = real(*args)

        def run(*a, **kw):
            calls[0] += 1
            return fn(*a, **kw)

        return run

    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        wl.cached_nst_program = counting
        try:
            _reset(counters)
            t0 = time.perf_counter()
            results = wl.main([*ONE_PROCESS, *argv, "--data_dir", data_dir or os.path.join(tmp, "no_data"),
                               "--device", "cuda"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {k: v for counts in counters for k, v in counts.items()}
            for root, _, files in os.walk(tmp) if arrays is not None else ():
                arrays.update({f: np.load(os.path.join(root, f)) for f in files if f.endswith(".npy")})
        finally:
            wl.cached_nst_program = real
            os.chdir(cwd)
    return results, launches, calls[0], wall


def _check_launches(where: str, launches: dict, nst_calls: int, stats_taps: bool, vgg_passes: int) -> None:
    """Every kernel of the path launched; conv1 once per VGG19 pass; with
    stats taps, exactly 4 style taps x (content pass + style pass + one per
    closure) forward and 4 x closures backward per NST call."""
    for k, n in launches.items():
        if n == 0 and (stats_taps or not k.startswith("relu_stats")):
            raise AssertionError(f"{k} was never launched by {where}")
    if launches["conv1"] != vgg_passes:
        raise AssertionError(f"{where} launched conv1 {launches['conv1']} times; one per VGG19 pass, "
                             f"{vgg_passes}, expected")
    if stats_taps:
        want = {"relu_stats_fwd": 4 * (MAIN_CLOSURES + 2) * nst_calls, "relu_stats_bwd": 4 * MAIN_CLOSURES * nst_calls}
        got = {k: launches[k] for k in want}
        if got != want or nst_calls == 0:
            raise AssertionError(f"{where} with --stats_taps on over {nst_calls} NST calls launched {got}; "
                                 f"{want} expected")
    elif launches["relu_stats_fwd"] or launches["relu_stats_bwd"]:
        raise AssertionError(f"{where} without --stats_taps launched relu_stats: {launches}")


def phase_main(card: str, stats_taps: bool = False):
    from iris_style_transfer_tpu_torch.ops import conv1 as c1
    from iris_style_transfer_tpu_torch.ops import relu_pool as rp
    from iris_style_transfer_tpu_torch.ops import relu_stats as rs
    from iris_style_transfer_tpu_torch.workloads import ist_openeds2019 as wl

    argv = ["-bs", "64", "--nst_epochs", str(MAIN_CLOSURES)] + (["--stats_taps", "on"] if stats_taps else [])
    results, launches, calls, _ = _run_main(wl, argv, (rp.LAUNCHES, rs.LAUNCHES, c1.LAUNCHES))
    log = results[("test/", 1.0, MAIN_CLOSURES)]
    keys = ["test/post/mean_miou", "test/stylized_images_per_min", "test/pipeline_images_per_min"]
    keys += [f"test/{p}/c{n}/{m}" for p in ("pre", "post") for n in (1, 2) for m in ("accu", "loss", "f1")]
    for k in keys:
        if k not in log or not math.isfinite(log[k]):
            raise AssertionError(f"workload metric {k} missing or not finite: {log.get(k)}")
    # per batch: one NST call (closures + 2 passes) and the pre- and post-NST classification
    _check_launches("the 2019 main", launches, calls, stats_taps, calls * (MAIN_CLOSURES + 4))
    _log("main", f"ist_openeds2019 bs 64, {MAIN_CLOSURES} closures, stats_taps {'on' if stats_taps else 'off'} "
         f"on {card}: stylized_images_per_min {log['test/stylized_images_per_min']:.1f}, "
         f"pipeline_images_per_min {log['test/pipeline_images_per_min']:.1f}, post mean_miou "
         f"{log['test/post/mean_miou']:.4f}, s_loss {log['test//s_loss']:.6g}, {calls} NST call(s), "
         f"launches {launches}")
    return launches


def phase_main2020(card: str, b7_apply_ms: float, stats_taps: bool = False):
    import torch
    from iris_style_transfer_tpu_torch.ops import conv1 as c1
    from iris_style_transfer_tpu_torch.ops import depthwise as dw
    from iris_style_transfer_tpu_torch.ops import relu_pool as rp
    from iris_style_transfer_tpu_torch.ops import relu_stats as rs
    from iris_style_transfer_tpu_torch.workloads import ist_openeds2020 as wl

    bs, chunk = 128, wl.SEG_CHUNK
    want_dw = 102 * (1 + 2 * bs // chunk)  # the style iris, then pre and post per chunk
    torch.cuda.reset_peak_memory_stats()
    argv = ["-bs", str(bs), "--nst_epochs", str(MAIN_CLOSURES)] + (["--stats_taps", "on"] if stats_taps else [])
    results, launches, calls, wall = _run_main(wl, argv, (rp.LAUNCHES, dw.LAUNCHES, rs.LAUNCHES, c1.LAUNCHES))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log = results[("validation/", 1.0, MAIN_CLOSURES)]
    keys = [f"validation//{p}/degree_distance{i}" for p in ("pre", "post") for i in (1, 2)]
    keys += ["validation//stylized_images_per_min", "validation//pipeline_images_per_min"]
    for k in keys:
        if k not in log or not math.isfinite(log[k]):
            raise AssertionError(f"workload metric {k} missing or not finite: {log.get(k)}")
    _check_launches("the 2020 main", launches, calls, stats_taps, calls * (MAIN_CLOSURES + 2))
    if launches["dw_conv_bn_silu"] != want_dw:
        raise AssertionError(f"dw_conv_bn_silu launched {launches['dw_conv_bn_silu']} times in the 2020 "
                             f"main; 102 x (1 + 2 x {bs}/{chunk}) = {want_dw} expected")
    body_s = bs * 60 / log["validation//pipeline_images_per_min"]
    nst_s = bs * 60 / log["validation//stylized_images_per_min"]
    b7_s = 2 * (bs // chunk) * b7_apply_ms / 1000
    _log("main2020", f"ist_openeds2020 bs {bs}, {MAIN_CLOSURES} closures, chunk {chunk}, stats_taps "
         f"{'on' if stats_taps else 'off'} on {card}: degree_distance pre {log[keys[0]]:.2f}/{log[keys[1]]:.2f}, "
         f"post {log[keys[2]]:.2f}/{log[keys[3]]:.2f}; stylized_images_per_min {log[keys[4]]:.1f}, "
         f"pipeline_images_per_min {log[keys[5]]:.1f}; {calls} NST call(s); launches {launches}; main "
         f"{wall:.1f} s; peak memory {peak_gb:.2f} GB")
    _log("main2020", f"batch body {body_s:.3f} s: NST {nst_s:.3f} s ({100 * nst_s / body_s:.1f}%), "
         f"B7 U-Net {2 * bs // chunk} chunk applies x {b7_apply_ms:.1f} ms = {b7_s:.3f} s "
         f"({100 * b7_s / body_s:.1f}%), rest {body_s - nst_s - b7_s:.3f} s")
    return launches


def _train_run(main, argv: list[str], counters) -> tuple[dict, dict, float, float]:
    """``main(argv)`` on the card in the current directory, every count in
    ``counters`` set to 0 just before and read just after; returns
    (metrics, launches, wall seconds, peak GB)."""
    import torch

    torch.cuda.reset_peak_memory_stats()
    _reset(counters)
    t0 = time.perf_counter()
    log = main([*ONE_PROCESS, *argv, "--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v for counts in counters for k, v in counts.items()}
    return log, launches, wall, torch.cuda.max_memory_allocated() / 1e9


def phase_train2019(card: str):
    """The port's iris_classification main at full width (VGG19 at 224x224,
    bs 64, bf16) on a twin of 8 users x 40 frames: two epochs with VGG19
    frozen, saving the heads; one epoch with --no-freeze_vgg; then the 2019
    IST main reading the trainer's checkpoint through -path1/-path2."""
    from iris_style_transfer_tpu_torch.data import synthetic_openeds2019
    from iris_style_transfer_tpu_torch.ops import conv1 as c1
    from iris_style_transfer_tpu_torch.ops import relu_pool as rp
    from iris_style_transfer_tpu_torch.ops import relu_stats as rs
    from iris_style_transfer_tpu_torch.workloads import ist_openeds2019 as ist
    from iris_style_transfer_tpu_torch.workloads import iris_classification as wl

    bs = 64
    real_twin = wl.synthetic_openeds2019
    cwd = os.getcwd()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        twins: dict = {}  # made once, for both runs and the counts below
        wl.synthetic_openeds2019 = lambda n_per_user=8, num_users=8, seed=0: twins.setdefault(
            seed, synthetic_openeds2019(n_per_user=TRAIN_FRAMES_PER_USER, num_users=TRAIN_USERS, seed=seed))
        try:
            _, train_y, _, _, test_y, _, _ = wl.synthetic_openeds2019(seed=42)  # the mains' default seed
            steps, test_batches = len(train_y) // bs, -(-len(test_y) // bs)
            nodata = ["--data_dir", os.path.join(tmp, "no_data")]
            for name, argv, epochs in (("frozen", ["-E", "2", "-SP", "2"], 2),
                                       ("trained", ["--no-freeze_vgg", "-E", "1", "-SP", "-1"], 1)):
                log, launches, wall, peak = _train_run(wl.main, ["-bs", str(bs), *argv, *nodata],
                                                       (c1.LAUNCHES, rp.LAUNCHES, rs.LAUNCHES))
                for k in ("train/c1/accu", "train/c2/loss", "test/c1/accu", "test/c2/accu", "test/c1/auc",
                          "train/steps_per_sec"):
                    if k not in log or not math.isfinite(log[k]):
                        raise AssertionError(f"iris_classification ({name}) metric {k} missing or not finite")
                want = {"conv1": epochs * (steps + test_batches), "relu_pool_fwd": epochs * (steps + test_batches),
                        "relu_pool_bwd": epochs * steps if name == "trained" else 0,
                        "relu_stats_fwd": 0, "relu_stats_bwd": 0}
                if launches != want:
                    raise AssertionError(f"iris_classification ({name}) launched {launches}; {want} expected")
                sps = log["train/steps_per_sec"]
                _log("train2019", f"iris_classification {name} VGG19, bs {bs}, {epochs} epoch(s) of {steps} steps "
                     f"+ {test_batches} test batch(es) on {card}: {sps:.3f} train steps/s = {sps * bs:.1f} "
                     f"images/s; peak memory {peak:.2f} GB; launches {launches}; test/c1/accu "
                     f"{log['test/c1/accu']:.4f}, test/c2/accu {log['test/c2/accu']:.4f}; main {wall:.1f} s")
                out[name] = {"steps_per_sec": sps, "launches": launches, "peak_gb": peak, "log": log}

            ckpt = os.path.join(tmp, "saved", "checkpoints", "iris_classification")
            if not os.path.exists(os.path.join(ckpt, "step_00000002.npz")):
                raise AssertionError(f"the trainer wrote no step_00000002.npz under {ckpt}")
            results = ist.main([*ONE_PROCESS, "-bs", "64", "--nst_epochs", str(MAIN_CLOSURES), "-path1", ckpt,
                                "-path2", ckpt, *nodata, "--device", "cuda"])
            log = results[("test/", 1.0, MAIN_CLOSURES)]
            for k in ("test/pre/c1/accu", "test/pre/c2/accu"):
                if k not in log or not math.isfinite(log[k]):
                    raise AssertionError(f"the 2019 IST main with the trainer's heads: {k} missing or not finite")
            _log("train2019", f"ist_openeds2019 with -path1/-path2 = the trainer's checkpoint, {MAIN_CLOSURES} "
                 f"closures: test/pre/c1/accu {log['test/pre/c1/accu']:.4f}, test/pre/c2/accu "
                 f"{log['test/pre/c2/accu']:.4f}, test/post/c1/accu {log['test/post/c1/accu']:.4f}, "
                 f"test/post/c2/accu {log['test/post/c2/accu']:.4f}")
        finally:
            wl.synthetic_openeds2019 = real_twin
            os.chdir(cwd)
    return out


def phase_train_gaze(card: str):
    """The port's gaze_estimation main on the gaze twin (96 training
    frames, bs 32, three learning rates): estimator 1 on the landmarks,
    estimator 2 with its ResNet50 trunk trained at 400x640 in bf16; then one
    timed estimator-2 step at the JAX default bs 128."""
    import torch
    from iris_style_transfer_tpu_torch.models import GazeEstimator2
    from iris_style_transfer_tpu_torch.ops import conv1 as c1
    from iris_style_transfer_tpu_torch.workloads import gaze_estimation as wl
    from iris_style_transfer_tpu_torch.workloads.iris_classification import trainable

    cwd = os.getcwd()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            for est, extra in (("1", ["-SP", "1"]), ("2", [])):
                log, launches, wall, peak = _train_run(
                    wl.main, ["-estimator", est, "-bs", "32", "-E", "1", *extra, "--data_dir",
                              os.path.join(tmp, "no_data")], (c1.LAUNCHES,))
                for k in ("train/loss", "train/degree_distance", "valid/loss", "valid/degree_distance",
                          "train/steps_per_sec"):
                    if k not in log or not math.isfinite(log[k]):
                        raise AssertionError(f"gaze_estimation -estimator {est}: metric {k} missing or not finite")
                if launches["conv1"]:
                    raise AssertionError(f"gaze_estimation runs no VGG19 but launched conv1 {launches['conv1']} times")
                sps = log["train/steps_per_sec"]
                _log("train_gaze", f"gaze_estimation -estimator {est} -bs 32 -E 1 (3 lrs x 3 steps) on {card}: "
                     f"{sps:.3f} train steps/s of the last lr = {sps * 32:.1f} frames/s; valid/degree_distance "
                     f"{log['valid/degree_distance']:.2f}; peak memory {peak:.2f} GB; main {wall:.1f} s")
                out[f"estimator{est}"] = {"steps_per_sec": sps, "peak_gb": peak, "log": log}
        finally:
            os.chdir(cwd)

    # one estimator-2 step at the JAX default batch on raw uint8 frames
    train_step, _ = wl.make_steps(2, torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    for bs in (128, 96, 64):
        params = GazeEstimator2.init(torch.Generator().manual_seed(SEED), extract_feature=True, device="cuda")
        opt = torch.optim.Adam(trainable(params), lr=1e-4)
        x = torch.randint(0, 256, (bs, 400, 640, 1), generator=gen, device="cuda", dtype=torch.uint8)
        y = torch.nn.functional.normalize(torch.randn((bs, 3), generator=gen, device="cuda"), dim=1)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        fits = True
        try:  # the one caught error: this probe measures whether a batch fits the card
            train_step(params, opt, x, y, gen)  # warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            train_step(params, opt, x, y, gen)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        except torch.cuda.OutOfMemoryError:
            fits = False
        peak = torch.cuda.max_memory_allocated() / 1e9
        del params, opt, x, y
        torch.cuda.empty_cache()
        if not fits:
            _log("train_gaze", f"estimator 2 at bs {bs} (400x640 uint8, bf16 trunk): out of memory on {card} "
                 f"(peak {peak:.2f} GB allocated before the failed allocation)")
            continue
        _log("train_gaze", f"estimator 2, one train step at bs {bs} on ({bs},400,640,1) uint8, bf16 trunk: "
             f"{dt * 1e3:.1f} ms = {bs / dt:.1f} frames/s; peak memory {peak:.2f} GB on {card}")
        out["step"] = {"bs": bs, "ms": dt * 1e3, "peak_gb": peak}
        break
    if "step" not in out:
        raise AssertionError("estimator 2 fit no batch of 128, 96 or 64 frames")
    return out


def phase_demos(card: str):
    """Both demos in-process on the card, into a temporary directory."""
    from iris_style_transfer_tpu_torch.demos import iris_nst_demo, nst_demo
    from iris_style_transfer_tpu_torch.ops import blockwise_gram as bg
    from iris_style_transfer_tpu_torch.ops import conv1 as c1

    with tempfile.TemporaryDirectory() as tmp:
        bg.LAUNCHES["gram_matrix"] = 0
        c1.LAUNCHES["conv1"] = 0
        out = os.path.join(tmp, "nst.png")
        res = nst_demo.main(["--gram", "--sw", str(GRAM_STYLE_WEIGHT), "--size", "512", "--epochs",
                             str(DEMO_CLOSURES), "--out", out, "--device", "cuda"])
        gram_launches = bg.LAUNCHES["gram_matrix"]
        if gram_launches != 4 * (DEMO_CLOSURES + 1) or c1.LAUNCHES["conv1"] != DEMO_CLOSURES + 2:
            raise AssertionError(f"nst_demo --gram launched the Gram kernel {gram_launches} times and conv1 "
                                 f"{c1.LAUNCHES['conv1']}; 4 x ({DEMO_CLOSURES} + 1) and {DEMO_CLOSURES} + 2 expected")
        s_hist = res.s_loss_hist.cpu()
        if not (os.path.getsize(out) > 0 and s_hist.isfinite().all() and s_hist[-1] < s_hist[0]):
            raise AssertionError(f"nst_demo --gram: PNG {os.path.exists(out)}, s_loss {s_hist.tolist()}")
        _log("demos", f"nst_demo --gram --sw {GRAM_STYLE_WEIGHT:g} --size 512 --epochs {DEMO_CLOSURES} on {card}: {gram_launches} Gram "
             f"kernel launches, s_loss {s_hist[0].item():.6g} -> {s_hist[-1].item():.6g}")

        outdir = os.path.join(tmp, "iris")
        res = iris_nst_demo.main(["--epochs", str(DEMO_CLOSURES), "--outdir", outdir, "--device", "cuda"])
        names = ("content_eye.png", "style_eye.png", "content_iris.png", "style_iris.png",
                 "stylized_iris.png", "result_eye.png")
        missing = [n for n in names if not os.path.exists(os.path.join(outdir, n))]
        s_hist = res.s_loss_hist.cpu()
        if missing or not (s_hist.isfinite().all() and s_hist[-1] < s_hist[0]):
            raise AssertionError(f"iris_nst_demo: missing {missing}, s_loss {s_hist.tolist()}")
        _log("demos", f"iris_nst_demo --epochs {DEMO_CLOSURES} on {card}: 6 PNGs, s_loss "
             f"{s_hist[0].item():.6g} -> {s_hist[-1].item():.6g}")
    return gram_launches

# the real-data phase's fake trees at 400x640: OpenEDS2019 users per split
# (about 20 frames each: some 64 test frames, some 256 training crops) and
# OpenEDS2020 sequences of 64 frames per split (384 training frames: three
# estimator-2 steps at bs 128; one validation batch of 128)
TREE_2019_USERS, TREE_2019_FRAMES = (6, 5, 5), 20
TREE_2020_SEQUENCES, TREE_2020_FRAMES = (6, 2, 1), 64
FRAME_H, FRAME_W = 400, 640
REAL_BS_2019, REAL_BS_2020 = 64, 128
DECODE_FRAMES = 128  # per filter type, for the decode rates (at most the 2020 tree's validation frames)
LOADER_THREADS = 8  # decode_gray_batch's default


def _decode_rates(tmp: str, frames) -> dict:
    """decode_gray_batch's frames/s on DECODE_FRAMES frames written with
    each filter type, on one thread and on the loader's threads, each timed
    twice in turns (the faster kept)."""
    import numpy as np
    from iris_style_transfer_tpu_torch.data import decode_gray_batch
    from iris_style_transfer_tpu_torch.utils.png import FILTER_TYPES, write_png

    rates = {}
    for ft in FILTER_TYPES:
        d = os.path.join(tmp, f"decode_{ft}")
        os.makedirs(d)
        paths = [os.path.join(d, f"{i:03d}.png") for i in range(DECODE_FRAMES)]
        with ThreadPoolExecutor(max_workers=LOADER_THREADS) as pool:
            list(pool.map(lambda i: write_png(paths[i], frames[i], ft), range(DECODE_FRAMES)))
        decoded = decode_gray_batch(paths, FRAME_H, FRAME_W, threads=LOADER_THREADS, dtype=np.uint8)
        if not (decoded[..., 0] == frames[:DECODE_FRAMES]).all():
            raise AssertionError(f"decode_gray_batch does not give back the frames written with filter {ft}")
        mb = sum(os.path.getsize(p) for p in paths) / DECODE_FRAMES / 1e6
        for threads in (1, LOADER_THREADS, LOADER_THREADS, 1):  # in turns; the faster of two
            t0 = time.perf_counter()
            decode_gray_batch(paths, FRAME_H, FRAME_W, threads=threads, dtype=decoded.dtype)
            rate = DECODE_FRAMES / (time.perf_counter() - t0)
            rates[(ft, threads)] = max(rate, rates.get((ft, threads), 0.0))
        _log("real_data", f"decode {FRAME_H}x{FRAME_W} gray PNG, filter {ft} ({mb:.3f} MB a file): "
             f"{rates[(ft, 1)]:.1f} frames/s on 1 thread, {rates[(ft, LOADER_THREADS)]:.1f} on "
             f"{LOADER_THREADS} threads ({os.cpu_count()} host cores)")
    return rates


def phase_real_data(card: str) -> dict:
    """The four mains from fake OpenEDS2019 and OpenEDS2020 trees on disk
    (``data/fake_openeds.py``, 400x640, every row filter): the 2019 IST
    main and the classifier trainer (bs 64), the 2020 IST main (bs 128;
    its prediction files bit-equal to those of the same frames fed from
    memory in the stream's order), the gaze trainer with estimator 1 (B7
    landmark extraction) and estimator 2 (bs 128, streamed); launch counts
    as the twin phases'; decode rates per filter type."""
    import random

    import numpy as np
    import torch
    from iris_style_transfer_tpu_torch.data import (batch_iterator, fake_openeds, load_data_openeds2019,
                                                    load_labels_openeds2020, synthetic_eye_batch)
    from iris_style_transfer_tpu_torch.ops import conv1 as c1
    from iris_style_transfer_tpu_torch.ops import depthwise as dw
    from iris_style_transfer_tpu_torch.ops import relu_pool as rp
    from iris_style_transfer_tpu_torch.ops import relu_stats as rs
    from iris_style_transfer_tpu_torch.workloads import gaze_estimation as gz
    from iris_style_transfer_tpu_torch.workloads import iris_classification as ic
    from iris_style_transfer_tpu_torch.workloads import ist_openeds2019 as ist19
    from iris_style_transfer_tpu_torch.workloads import ist_openeds2020 as ist20

    t_phase = time.perf_counter()
    out = {}
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "data")
        t0 = time.perf_counter()
        tree19 = fake_openeds.write_openeds2019(data, TREE_2019_USERS, TREE_2019_FRAMES, FRAME_H, FRAME_W, SEED)
        tree20 = fake_openeds.write_openeds2020(data, TREE_2020_SEQUENCES, TREE_2020_FRAMES, FRAME_H, FRAME_W, SEED)
        n_files = sum(name.endswith(".png") for _, _, names in os.walk(data) for name in names)
        _log("real_data", f"fake trees: {n_files} PNGs at {FRAME_H}x{FRAME_W} written in "
             f"{time.perf_counter() - t0:.1f} s")
        # the validation frames the tree was written from (write_openeds2020's seed + 1)
        n_val = TREE_2020_SEQUENCES[1] * TREE_2020_FRAMES
        val_frames = np.round(np.clip(synthetic_eye_batch(n_val, FRAME_H, FRAME_W, seed=SEED + 1, gaze=True)[0], 0, 1)
                              * 255).astype(np.uint8)
        out["decode"] = _decode_rates(tmp, val_frames[..., 0])

        # the 2019 IST main: the test part of every user's frames
        argv = ["-bs", str(REAL_BS_2019), "--nst_epochs", str(MAIN_CLOSURES)]
        results, launches, calls, wall = _run_main(ist19, argv, (rp.LAUNCHES, rs.LAUNCHES, c1.LAUNCHES), data)
        log = results[("test/", 1.0, MAIN_CLOSURES)]
        for k in ("test/post/mean_miou", "test/pre/c1/accu", "test/post/c2/accu", "test/pipeline_images_per_min"):
            if k not in log or not math.isfinite(log[k]):
                raise AssertionError(f"ist_openeds2019 on the 2019 tree: {k} missing or not finite")
        _check_launches("the 2019 main on the 2019 tree", launches, calls, False, calls * (MAIN_CLOSURES + 4))
        _log("real_data", f"ist_openeds2019 on the 2019 tree, bs {REAL_BS_2019}, {MAIN_CLOSURES} closures on {card}: "
             f"{calls} batch(es); post mean_miou {log['test/post/mean_miou']:.4f}, pipeline_images_per_min "
             f"{log['test/pipeline_images_per_min']:.1f}; launches {launches}; main {wall:.1f} s")

        # the classifier trainer: split sizes from the loader under the main's seed
        random.seed(42)
        _, train_y, _, _, test_y, _, _ = load_data_openeds2019(load_seg=False, data_dir=tree19)
        steps, test_batches = len(train_y) // REAL_BS_2019, -(-len(test_y) // REAL_BS_2019)
        os.chdir(tmp)
        try:
            log, launches, wall, peak = _train_run(ic.main, ["-bs", str(REAL_BS_2019), "-E", "1", "-SP", "-1",
                                                             "--data_dir", data],
                                                   (c1.LAUNCHES, rp.LAUNCHES, rs.LAUNCHES))
        finally:
            os.chdir(cwd)
        want = {"conv1": steps + test_batches, "relu_pool_fwd": steps + test_batches, "relu_pool_bwd": 0,
                "relu_stats_fwd": 0, "relu_stats_bwd": 0}
        if launches != want or steps == 0:
            raise AssertionError(f"iris_classification on the 2019 tree launched {launches}; {want} expected")
        for k in ("train/c1/accu", "test/c2/accu", "train/steps_per_sec"):
            if k not in log or not math.isfinite(log[k]):
                raise AssertionError(f"iris_classification on the 2019 tree: {k} missing or not finite")
        _log("real_data", f"iris_classification on the 2019 tree, bs {REAL_BS_2019}, 1 epoch of {steps} steps "
             f"({len(train_y)} crops) + {test_batches} test batch(es) on {card}: "
             f"{log['train/steps_per_sec']:.3f} steps/s; launches {launches}; peak {peak:.2f} GB; main {wall:.1f} s")

        # the 2020 IST main from disk, then the same frames from memory;
        # cuDNN's deterministic algorithms in both, so that equal inputs give equal bits
        bs, chunk = REAL_BS_2020, ist20.SEG_CHUNK
        labels = load_labels_openeds2020(tree20, "validation/")
        preds, real_stream = {}, ist20.stream_openeds2020
        deterministic = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            for run in ("disk", "memory"):
                if run == "memory":
                    ist20.stream_openeds2020 = lambda path, postfix, b: batch_iterator((val_frames, labels), b,
                                                                                       pad_final=True)
                preds[run] = {}
                try:
                    results, launches, calls, wall = _run_main(
                        ist20, ["-bs", str(bs), "--nst_epochs", str(MAIN_CLOSURES)],
                        (rp.LAUNCHES, dw.LAUNCHES, rs.LAUNCHES, c1.LAUNCHES), data, preds[run])
                finally:
                    ist20.stream_openeds2020 = real_stream
                if run == "disk":
                    log = results[("validation/", 1.0, MAIN_CLOSURES)]
                    keys = [f"validation//{p}/degree_distance{i}" for p in ("pre", "post") for i in (1, 2)]
                    for k in keys + ["validation//pipeline_images_per_min"]:
                        if k not in log or not math.isfinite(log[k]):
                            raise AssertionError(f"ist_openeds2020 on the 2020 tree: {k} missing or not finite")
                    _check_launches("the 2020 main on the 2020 tree", launches, calls, False,
                                    calls * (MAIN_CLOSURES + 2))
                    want_dw = 102 * (1 + 2 * calls * -(-bs // chunk))
                    if launches["dw_conv_bn_silu"] != want_dw:
                        raise AssertionError(f"the 2020 main on the 2020 tree launched dw_conv_bn_silu "
                                             f"{launches['dw_conv_bn_silu']} times; {want_dw} expected")
                    _log("real_data", f"ist_openeds2020 on the 2020 tree, bs {bs}, {MAIN_CLOSURES} closures, "
                         f"cuDNN deterministic, on {card}: {calls} batch(es) of {n_val} frames; degree_distance "
                         f"pre {log[keys[0]]:.2f}/{log[keys[1]]:.2f}, post {log[keys[2]]:.2f}/{log[keys[3]]:.2f}; "
                         f"pipeline_images_per_min {log['validation//pipeline_images_per_min']:.1f}; launches "
                         f"{launches}; main {wall:.1f} s")
        finally:
            torch.backends.cudnn.deterministic = deterministic
        names = [f"preds{i}_{p}.npy" for p in ("pre", "post") for i in (1, 2)] + ["labels.npy", "gts.npy"]
        for n in names:
            a, b = preds["disk"].get(n), preds["memory"].get(n)
            if a is None or b is None or a.shape != b.shape or a.tobytes() != b.tobytes():
                raise AssertionError(f"ist_openeds2020: {n} from disk differs from the in-memory run's")
        if len(preds["disk"]["preds1_pre.npy"]) != n_val:
            raise AssertionError(f"ist_openeds2020 predicted {len(preds['disk']['preds1_pre.npy'])} frames, "
                                 f"not {n_val}")
        _log("real_data", f"ist_openeds2020: {', '.join(names)} from disk bit-equal to the in-memory run's "
             f"({n_val} frames in the stream's order)")

        # the gaze trainer: estimator 1 on B7 landmarks, estimator 2 streamed at bs 128
        n_train = TREE_2020_SEQUENCES[0] * TREE_2020_FRAMES
        for est in ("1", "2"):
            torch.cuda.empty_cache()
            os.chdir(tmp)
            try:
                log, launches, wall, peak = _train_run(
                    gz.main, ["-estimator", est, "-bs", str(bs), "-E", "1", "-SP", "-1", "--data_dir", data],
                    (c1.LAUNCHES, dw.LAUNCHES))
            finally:
                os.chdir(cwd)
            for k in ("train/loss", "train/degree_distance", "valid/degree_distance", "train/steps_per_sec"):
                if k not in log or not math.isfinite(log[k]):
                    raise AssertionError(f"gaze_estimation -estimator {est} on the 2020 tree: {k} missing or "
                                         "not finite")
            b7_applies = -(-n_train // chunk) + -(-n_val // chunk)  # the loader's chunks of 32
            want = {"conv1": 0, "dw_conv_bn_silu": 102 * b7_applies if est == "1" else 0}
            if launches != want:
                raise AssertionError(f"gaze_estimation -estimator {est} on the 2020 tree launched {launches}; "
                                     f"{want} expected")
            fps = log["train/steps_per_sec"] * bs
            out[f"estimator{est}"] = {"frames_per_sec": fps, "peak_gb": peak, "wall_s": wall}
            _log("real_data", f"gaze_estimation -estimator {est} -bs {bs} on the 2020 tree ({n_train} training frames"
                 f"{', streamed' if est == '2' else ', B7 landmarks'}) on {card}: {log['train/steps_per_sec']:.3f} "
                 f"train steps/s of the last lr = {fps:.1f} frames/s; valid/degree_distance "
                 f"{log['valid/degree_distance']:.2f}; launches {launches}; peak {peak:.2f} GB; main {wall:.1f} s")
    trainer = out["estimator2"]["frames_per_sec"]
    for ft in sorted({ft for ft, _ in out["decode"]}, key=str):
        threaded = out["decode"][(ft, LOADER_THREADS)]
        _log("real_data", f"decode vs the estimator-2 trainer (bs {REAL_BS_2020}, {trainer:.1f} frames/s) on {card} "
             f"with {os.cpu_count()} host cores: filter {ft}: {threaded:.1f} frames/s on {LOADER_THREADS} threads = "
             f"{threaded / trainer:.2f}x, {out['decode'][(ft, 1)]:.1f} on 1 thread = "
             f"{out['decode'][(ft, 1)] / trainer:.2f}x")
    _log("real_data", f"phase took {time.perf_counter() - t_phase:.1f} s")
    return out


# the replication phase's cuts (the tools' flags; full width: 400x640 frames,
# full VGG19, RITnet, B7 and ResNet50)
REP_2019 = {"users": 8, "n_per_user": 8, "ritnet_epochs": 2, "epochs": 3, "bs": 16, "ist_bs": 8}
REP_ROT_ANGLES, REP_ROT_PERS = (0, 90), (0, 0.4)
REP_GAZE = {"n_train": 16, "n_eval": 8, "effnet_epochs": 1, "estimator1_steps": 50, "estimator2_epochs": 1,
            "ist_bs": 8}
REP_SEED = 42  # the tools' default
REP_KEYS_2019 = ("ritnet/train_miou", "train/c1/accu", "train/c2/accu", "test/c1/accu", "test/c2/accu",
                 "ist/pre/c1/accu", "ist/pre/c2/accu", "ist/post/c1/accu", "ist/post/c2/accu",
                 "ist/post/c1/mis/accu", "ist/post/c2/mis/accu", "ist/pre/mean_miou", "ist/post/mean_miou",
                 "chance", "stylized_images_per_min")
REP_KEYS_GAZE = ("effnet/eval_miou", "pre/degree_distance1", "pre/degree_distance2", "post/degree_distance1",
                 "post/degree_distance2", "chance_degree_distance", "stylized_images_per_min")


def _flags(cuts: dict) -> list[str]:
    return [a for k, v in cuts.items() for a in (f"--{k}", str(v))]


def _check_summary(where: str, summary: dict, keys) -> None:
    missing = [k for k in keys if k not in summary or not math.isfinite(summary[k])]
    if missing:
        raise AssertionError(f"{where}: summary keys missing or not finite: {missing}")


def _b7_step_split(card: str) -> dict:
    """One B7 training step at bs 2 on 400x640 frames (the gaze tool's
    ``b7_train_loss`` and Adam), split three ways in device time: the
    depthwise kernel's forward (each launch's mean time x its 51 launches),
    the plain f32 depthwise backward (the device time torch.profiler gives
    the ``DwConvBnSiluBackward`` nodes of the traced step; also its 51
    calls at the step's shapes alone, in device time) and the rest of the
    step's device time.  The step's wall time in CUDA events beside it says
    how far the host sets the pace."""
    import torch
    from iris_style_transfer_tpu_torch.data import synthetic_eye_batch
    from iris_style_transfer_tpu_torch.models import EfficientNet
    from iris_style_transfer_tpu_torch.ops import depthwise as dw
    from iris_style_transfer_tpu_torch.tools.replicate_synthetic_gaze import b7_train_loss
    from iris_style_transfer_tpu_torch.workloads.iris_classification import trainable

    imgs, segs, _ = synthetic_eye_batch(2, seed=SEED)
    x, y = torch.from_numpy(imgs).cuda(), torch.from_numpy(segs).long().cuda()
    params = EfficientNet.init(torch.Generator().manual_seed(SEED), device="cuda")
    opt = torch.optim.Adam(trainable(params), lr=1e-3)

    def step():
        loss = b7_train_loss(params, x, y)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()

    wall_ms = min(_time_ms(step, iters=5) for _ in range(2))
    step_ms = _device_ms(step, n=2)

    def backward_nodes(ev):
        return max((getattr(e, "device_time_total", 0) for e in ev if "DwConvBnSiluBackward" in e.key), default=0)

    before = dw.LAUNCHES["dw_conv_bn_silu"]
    ev, tries = _trace(step, lambda ev: backward_nodes(ev) > 0 and any("dw_conv_bn_silu_kernel" in e.key for e in ev),
                       "dw_conv_bn_silu_kernel and the DwConvBnSiluBackward nodes in one B7 training step")
    launched = (dw.LAUNCHES["dw_conv_bn_silu"] - before) / tries
    if launched != 51:
        raise AssertionError(f"one B7 training step launched dw_conv_bn_silu {launched} times; 51 expected")
    kernel = [e for e in _device_events(ev) if "dw_conv_bn_silu_kernel" in e.key]
    fwd_ms = sum(e.self_device_time_total / e.count for e in kernel) * 51 / 1e3
    bwd_ms = backward_nodes(ev) / 1e3

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    calls = []
    for (k, c, h, w), n in _b7_depthwise_shapes().items():
        xb, wt, a, b = _dw_inputs((2, h, w, c), k, torch.bfloat16, gen)
        gy = torch.randn(xb.shape, generator=gen, device="cuda").to(torch.bfloat16)
        gy = gy.contiguous(memory_format=torch.channels_last)
        calls += [(xb, wt.float(), a, b, k, gy)] * n  # w stays float32 in training

    def backward_all():
        for xb, wt, a, b, k, gy in calls:
            dw.dw_conv_bn_silu_bwd(xb, wt, a, b, k, gy)

    alone_ms = _device_ms(backward_all, n=2)
    out = {"wall_ms": wall_ms, "device_ms": step_ms, "dw_fwd_ms": fwd_ms, "dw_bwd_ms": bwd_ms,
           "dw_bwd_alone_ms": alone_ms, "rest_ms": step_ms - fwd_ms - bwd_ms}
    _log("replicate", f"one B7 training step at (2,400,640,1) bs 2, bf16 activations, on {card}: wall "
         f"{wall_ms:.2f} ms (CUDA events), device {step_ms:.2f} ms: depthwise forward kernel {fwd_ms:.2f} ms "
         f"({100 * fwd_ms / step_ms:.1f}%), plain f32 depthwise backward {bwd_ms:.2f} ms ({100 * bwd_ms / step_ms:.1f}%; "
         f"its 51 calls alone {alone_ms:.2f} ms), rest {out['rest_ms']:.2f} ms ({100 * out['rest_ms'] / step_ms:.1f}%)")
    return out


def phase_replicate(card: str) -> dict:
    """The three replication tools in-process on the card at full width
    (400x640 twin frames; full VGG19, RITnet, B7 and ResNet50) and cut
    depth, in a temporary working directory: every summary key present
    and finite, B7's training loss falling, launches as the cuts derive
    them; then the B7 training step's split."""
    import torch
    from iris_style_transfer_tpu_torch.data import synthetic_openeds2019
    from iris_style_transfer_tpu_torch.ops import conv1 as c1
    from iris_style_transfer_tpu_torch.ops import depthwise as dw
    from iris_style_transfer_tpu_torch.ops import relu_pool as rp
    from iris_style_transfer_tpu_torch.ops import relu_stats as rs
    from iris_style_transfer_tpu_torch.tools import replicate_rotation as tool_rot
    from iris_style_transfer_tpu_torch.tools import replicate_synthetic as tool_2019
    from iris_style_transfer_tpu_torch.tools import replicate_synthetic_gaze as tool_gaze
    from iris_style_transfer_tpu_torch.workloads.ist_openeds2020 import SEG_CHUNK

    t_phase = time.perf_counter()
    counters = (c1.LAUNCHES, rp.LAUNCHES, rs.LAUNCHES, dw.LAUNCHES)
    twins: dict = {}  # made once, for both recognition tools and the counts below
    real_twin, real_b7 = (tool_2019.synthetic_openeds2019, tool_rot.synthetic_openeds2019), tool_gaze.train_efficientnet
    b7_losses = []

    def twin(n_per_user=6, num_users=8, seed=0):
        return twins.setdefault((n_per_user, num_users, seed), synthetic_openeds2019(n_per_user, num_users, seed))

    def train_b7(*a, **k):
        params, losses = real_b7(*a, **k)
        b7_losses.append(losses)
        return params, losses

    out = {}
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        tool_2019.synthetic_openeds2019 = tool_rot.synthetic_openeds2019 = twin
        tool_gaze.train_efficientnet = train_b7
        try:
            _, train_y, _, _, test_y, _, _ = twin(REP_2019["n_per_user"], REP_2019["users"], REP_SEED)
            n_train, n_test = len(train_y), len(test_y)
            runs = (
                ("recognition", tool_2019.main, _flags(REP_2019) + ["--nst_epochs", str(MAIN_CLOSURES)]),
                ("rotation", tool_rot.main, ["--users", str(REP_2019["users"]), "--n_per_user",
                                             str(REP_2019["n_per_user"]), "--angles", ",".join(map(str, REP_ROT_ANGLES)),
                                             "--pers", ",".join(map(str, REP_ROT_PERS))]),
                ("gaze", tool_gaze.main, _flags(REP_GAZE) + ["--nst_epochs", str(MAIN_CLOSURES)]),
            )
            for name, main, argv in runs:
                _reset(counters)
                t0 = time.perf_counter()
                summary = main([*argv, "--device", "cuda"])
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                launches = {k: v for counts in counters for k, v in counts.items()}
                out[name] = {"summary": summary, "launches": launches, "wall_s": wall}
                _log("replicate", f"{name} on {card}: {wall:.1f} s; launches {launches}; summary {summary}")
        finally:
            tool_2019.synthetic_openeds2019, tool_rot.synthetic_openeds2019 = real_twin
            tool_gaze.train_efficientnet = real_b7
            os.chdir(cwd)

    # the launches each cut derives: conv1 and relu_pool_fwd once per VGG19
    # pass, relu_pool_bwd once per NST closure, the depthwise kernel 51
    # times per B7 training forward and 102 per flip-TTA apply
    ist_batches = -(-n_test // REP_2019["ist_bs"])
    vgg_2019 = (REP_2019["epochs"] * (n_train // REP_2019["bs"] + -(-n_test // REP_2019["bs"]))
                + ist_batches * (MAIN_CLOSURES + 4))
    vgg_rot = -(-n_test // 8) * sum(1 if level == 0 else 2 for level in REP_ROT_ANGLES + REP_ROT_PERS)
    g = REP_GAZE
    b7_applies = (-(-g["n_eval"] // 8) + -(-g["n_train"] // 8) + 1
                  + 2 * -(-g["n_eval"] // g["ist_bs"]) * -(-g["ist_bs"] // SEG_CHUNK))
    gaze_nst = -(-g["n_eval"] // g["ist_bs"])
    want = {
        "recognition": {"conv1": vgg_2019, "relu_pool_fwd": vgg_2019, "relu_pool_bwd": ist_batches * MAIN_CLOSURES,
                        "relu_stats_fwd": 0, "relu_stats_bwd": 0, "dw_conv_bn_silu": 0},
        "rotation": {"conv1": vgg_rot, "relu_pool_fwd": vgg_rot, "relu_pool_bwd": 0, "relu_stats_fwd": 0,
                     "relu_stats_bwd": 0, "dw_conv_bn_silu": 0},
        "gaze": {"conv1": gaze_nst * (MAIN_CLOSURES + 2), "relu_pool_fwd": gaze_nst * (MAIN_CLOSURES + 2),
                 "relu_pool_bwd": gaze_nst * MAIN_CLOSURES, "relu_stats_fwd": 0, "relu_stats_bwd": 0,
                 "dw_conv_bn_silu": 51 * g["effnet_epochs"] * (g["n_train"] // 2) + 102 * b7_applies},
    }
    for name, w in want.items():
        if out[name]["launches"] != w:
            raise AssertionError(f"replicate {name} launched {out[name]['launches']}; {w} expected")
    _check_summary("replicate_synthetic", out["recognition"]["summary"], REP_KEYS_2019)
    rot_keys = [f"{kind}/{lv:g}/{h}" for kind, levels in (("rot", REP_ROT_ANGLES), ("pers", REP_ROT_PERS))
                for lv in levels for h in ("c1", "c2") + (("retention_c1", "retention_c2") if lv else ())]
    _check_summary("replicate_rotation", out["rotation"]["summary"], ["chance", *rot_keys])
    _check_summary("replicate_synthetic_gaze", out["gaze"]["summary"], REP_KEYS_GAZE)
    losses = b7_losses[0]
    if not (len(losses) == g["n_train"] // 2 and torch.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"B7's training loss did not fall over its steps: {losses.tolist()}")
    _log("replicate", f"B7 training loss over {len(losses)} steps at bs 2: {losses[0].item():.4f} -> "
         f"{losses[-1].item():.4f}; launches as derived: {want}")
    out["b7_step"] = _b7_step_split(card)
    _log("replicate", f"phase took {time.perf_counter() - t_phase:.1f} s")
    return out


# phase 12: the mains on ranks of a process group.  The timing keys are the
# ranks' own clocks, and are not compared.
TIMING_KEYS = ("per_min", "per_sec")
# the IST mains' NST closures before L-BFGS's first curvature pair: one
# process's and the ranks' style losses agree to 1e-5 there, and part after
# it (see phase_parallel)
AGREEING_CLOSURES = 3
PARALLEL_NST_CLOSURES = 100  # each of the four NST loops timed in turns
PARALLEL_JOIN_S = 600  # a spawned run that outlasts this fails the phase
IST_RUNS = {  # the main phases' arguments, and the key of their results
    "ist2019": (["-bs", "64", "--nst_epochs", str(MAIN_CLOSURES), "--stats_taps", "on"], ("test/", 1.0, MAIN_CLOSURES)),
    "ist2020": (["-bs", "128", "--nst_epochs", str(MAIN_CLOSURES)], ("validation/", 1.0, MAIN_CLOSURES)),
}
CLASSIFIER_ARGS = ["-bs", "64", "-E", "2", "-SP", "-1"]  # phase_train2019's frozen run, without its checkpoint


def _counters():
    from iris_style_transfer_tpu_torch.ops import conv1 as c1
    from iris_style_transfer_tpu_torch.ops import depthwise as dw
    from iris_style_transfer_tpu_torch.ops import relu_pool as rp
    from iris_style_transfer_tpu_torch.ops import relu_stats as rs

    return rp.LAUNCHES, rs.LAUNCHES, c1.LAUNCHES, dw.LAUNCHES


def _nodata_main(wl, argv: list[str], where: str, arrays: bool = True) -> dict:
    """``wl.main(argv)`` on the card in ``where`` (made if missing; ranks
    share it) on the twin, with cuDNN's deterministic algorithms; every
    count set to 0 just before and read just after; each NST call's loss
    histories captured.  Returns {"results", "launches", "hists", "arrays"
    (with ``arrays``, every ``.npy`` the run wrote, by name)}."""
    import numpy as np
    import torch

    os.makedirs(where, exist_ok=True)
    real, hists = getattr(wl, "cached_nst_program", None), []

    def capturing(*args):
        fn = real(*args)

        def run(*a, **kw):
            res = fn(*a, **kw)
            hists.append((res.c_loss_hist.cpu(), res.s_loss_hist.cpu()))
            return res

        return run

    cwd, det = os.getcwd(), torch.backends.cudnn.deterministic
    os.chdir(where)
    torch.backends.cudnn.deterministic = True
    if real is not None:
        wl.cached_nst_program = capturing
    try:
        _reset(_counters())
        results = wl.main([*ONE_PROCESS, *argv, "--data_dir", os.path.join(where, "no_data"), "--device", "cuda"])
        torch.cuda.synchronize()
        launches = {k: v for counts in _counters() for k, v in counts.items()}
        arrays = {f: np.load(os.path.join(root, f)) for root, _, files in os.walk(where) if arrays for f in files
                  if f.endswith(".npy")}
    finally:
        if real is not None:
            wl.cached_nst_program = real
        torch.backends.cudnn.deterministic = det
        os.chdir(cwd)
    return {"results": results, "launches": launches, "hists": hists, "arrays": arrays}


def _rank_nccl_world1(argv: list[str], tmp: str) -> dict:
    """Rank 0 of an NCCL group of one, on cuda:0: the 2019 main as the
    one-process run of :func:`phase_parallel`; the stats-tap NST loop at bs
    64 on a mesh of the group under ``set_sync_debug_mode("error")``; then
    the loop without and with the group, in turns, for closures/s."""
    import torch.distributed as dist
    from iris_style_transfer_tpu_torch.parallel import make_mesh
    from iris_style_transfer_tpu_torch.workloads import ist_openeds2019

    run = _nodata_main(ist_openeds2019, argv, os.path.join(tmp, "nccl"))
    mesh = make_mesh()
    rates: dict = {"plain": [], "group": []}
    for kind in ("plain", "group", "group", "plain"):
        kw = {"stats_taps": True, **({"mesh": mesh} if kind == "group" else {})}
        rates[kind].append(_nst_loop(kw, (64, 3, 224, 224), PARALLEL_NST_CLOSURES, SEED + 1)[0])
    return {**run, "rates": rates, "mesh": mesh.shape, "backend": dist.get_backend()}


def _rank_gloo_mains(tmp: str) -> list:
    """One of two gloo ranks, both on cuda:0: the 2019 main (stats taps on),
    the 2020 main, the classifier trainer with ``--model_parallel 2`` and
    the gaze trainer (estimator 1), each with ``--n_devices 2`` at the
    one-process phases' arguments, in directories both ranks share.
    Returns rank 0's runs and every rank's launches.  gloo copies CUDA
    tensors through the host, so these runs hold no sync check."""
    import torch.distributed as dist
    from iris_style_transfer_tpu_torch.workloads import gaze_estimation, iris_classification, ist_openeds2019
    from iris_style_transfer_tpu_torch.workloads import ist_openeds2020

    _train_twin(iris_classification)
    runs = {
        "ist2019": (ist_openeds2019, IST_RUNS["ist2019"][0]),
        "ist2020": (ist_openeds2020, IST_RUNS["ist2020"][0]),
        "classifier": (iris_classification, [*CLASSIFIER_ARGS, "--model_parallel", "2"]),
        "gaze": (gaze_estimation, ["-estimator", "1", "-bs", "32", "-E", "1", "-SP", "1"]),
    }
    runs.update({f"spatial_{name}": (wl, [*IST_RUNS[name][0], "--model_parallel", "2"])
                 for name, wl in (("ist2019", ist_openeds2019), ("ist2020", ist_openeds2020))})
    out = {}
    for name, (wl, argv) in runs.items():
        t0 = time.perf_counter()
        out[name] = _nodata_main(wl, [*argv, "--n_devices", "2"], os.path.join(tmp, name), arrays=False)
        out[name]["wall"] = time.perf_counter() - t0
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, {k: v["launches"] for k, v in out.items()})
    t0 = time.perf_counter()
    split = _vgg_split_errors()
    errs = [None] * dist.get_world_size()
    dist.all_gather_object(errs, split)
    return [out, every, errs, time.perf_counter() - t0]


# the direct check of VGG19 split on H over two ranks, in bf16: each tap and
# input gradient of the slab within this share of the one-process tensor's
# largest magnitude (the slab's convs may take other cuDNN algorithms than
# the whole image's, each rounding its bf16 output once more or less)
SPLIT_REL_TOL = 2e-2


def _vgg_split_errors() -> dict:
    """One of two ranks of a model group on the card: VGG19 (seeded,
    truncated at relu4_2, bf16) forward and backward at (64, 3, 224, 224)
    on this rank's slab of 112 rows, against the same on the whole image
    in this process: the classic taps and the input gradient of a fixed
    random weighting of them, then the stats taps' (mean, std) pairs and
    the input gradient of their sum.  Returns each tensor's largest
    deviation over its largest magnitude, on this rank's rows."""
    import torch
    from iris_style_transfer_tpu_torch.models import VGG19
    from iris_style_transfer_tpu_torch.parallel import make_mesh, spatial_sharding

    mesh = make_mesh(model_parallel=2)
    shape = (64, 3, 224, 224)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    x_all = torch.rand(shape, generator=gen, device="cuda")
    params = VGG19.cast(VGG19.init(torch.Generator().manual_seed(SEED), device="cuda"), torch.bfloat16)
    names = ("relu4_2", "relu1_1", "relu2_1", "relu3_1", "relu4_1")
    j = mesh.model_index
    weights: dict = {}

    def mine(t, whole: bool):
        """This rank's rows of a whole-image tensor (H at dim 2)."""
        h = t.shape[2] // 2
        return t[:, :, j * h:(j + 1) * h] if whole else t

    def run(x, m):
        whole = m is None
        kw = dict(content_layers=names[:1], style_layers=names[1:], compute_dtype=torch.bfloat16, truncate=True,
                  mesh=m)
        x = x.clone().requires_grad_(True)
        _, content, style = VGG19.apply(params, x, **kw)
        taps = [*content, *style]
        loss = 0.0
        for i, t in enumerate(taps):  # one weighting of each whole tap, drawn once; this block's rows of it
            w = weights.setdefault(i, torch.rand((t.shape[0], t.shape[1], t.shape[2] * (1 if whole else 2),
                                                  t.shape[3]), generator=gen, device="cuda"))
            loss = loss + (t.float() * (w if whole else mine(w, True))).sum()
        (g,) = torch.autograd.grad(loss, x)
        x2 = x.detach().clone().requires_grad_(True)
        _, _, pairs = VGG19.apply(params, x2, stats_taps=True, **kw)
        stats = [t for pair in pairs for t in pair]
        (g2,) = torch.autograd.grad(sum(t.sum() for t in stats), x2)
        rows = [mine(t.detach(), whole) for t in (*taps, g, g2)]
        return rows, stats

    got, got_stats = run(x_all[spatial_sharding(mesh, shape)], mesh)
    want, want_stats = run(x_all, None)
    labels = [*names, "taps' input gradient", "stats taps' input gradient"]
    labels += [f"{n} {k}" for n in names[1:] for k in ("mean", "std")]
    return {what: ((g.float() - w.float()).abs().max() / w.float().abs().max()).item()
            for what, g, w in zip(labels, [*got, *got_stats], [*want, *want_stats])}


def _compare_metrics(where: str, got: dict, want: dict, tol) -> float:
    """Every metric of ``want`` present in ``got``, each within ``tol(key)``
    of it; a key whose ``tol`` is None, and the timing keys, only finite.
    Returns the largest deviation, for the log."""
    if got.keys() != want.keys():
        raise AssertionError(f"{where}: keys differ: {sorted(got.keys() ^ want.keys())}")
    worst, bad = 0.0, []
    for k, v in want.items():
        t = None if k.endswith(TIMING_KEYS) else tol(k)
        if t is None:
            if not math.isfinite(got[k]):
                bad.append(f"{k} = {got[k]}")
            continue
        if not abs(got[k] - v) <= t:
            bad.append(f"{k} = {got[k]} on the ranks, {v} in one process (atol {t:g})")
        worst = max(worst, abs(got[k] - v))
    if bad:
        raise AssertionError(f"{where}: " + "; ".join(bad))
    return worst


def _trainer_tol(key: str) -> float:
    """The trainers' metrics: losses and distances within 1e-3; the metrics
    of ranks and argmaxes (auc, accu, prec, recl, f1, mcc) within 0.05: a
    few crops flip between logits that a batch split moves by bf16 rounding
    (another conv algorithm for another batch size), and the untrained
    heads' logits nearly tie.  On the CPU in float32 the split equals one
    process in every metric."""
    return 0.05 if key.rsplit("/", 1)[-1] in ("auc", "accu", "prec", "recl", "f1", "mcc") else 1e-3


def _dw_launches(rows: int, chunk: int) -> int:
    """The depthwise kernel's launches in one 2020-main batch of ``rows``
    frames a rank: B7 on the style iris, then pre and post per chunk."""
    return 102 * (1 + 2 * math.ceil(rows / chunk))


def _train_twin(wl) -> None:
    """phase_train2019's twin (8 users x 40 frames) for ``wl``, the
    classifier trainer's module."""
    from iris_style_transfer_tpu_torch.data import synthetic_openeds2019

    twins: dict = {}
    wl.synthetic_openeds2019 = lambda n_per_user=8, num_users=8, seed=0: twins.setdefault(
        seed, synthetic_openeds2019(n_per_user=TRAIN_FRAMES_PER_USER, num_users=TRAIN_USERS, seed=seed))


def _check_ranks(phase: str, where: str, name: str, run: dict, every: list, want_log: dict, want_launches: dict,
                 want_hists: list | None, s_rtol: float = 1e-4) -> None:
    """Rank 0's ``run`` of main ``name`` against one process's log (and, for
    an IST main, its NST histories), as :func:`phase_parallel` holds them,
    the first closures' style losses to ``s_rtol``; every rank's launches
    (``every``) against ``want_launches``."""
    import torch

    main = name.removeprefix("spatial_")
    key = IST_RUNS[main][1] if main in IST_RUNS else None
    got_log = run["results"][key] if key else run["results"]
    final = {}
    if key:
        worst = _compare_metrics(where, got_log, want_log, lambda k: None if "/post/" in k or "_loss" in k else 1e-4)
        if len(run["hists"]) != len(want_hists):
            raise AssertionError(f"{where}: {len(run['hists'])} NST calls, {len(want_hists)} in one process")
        k = AGREEING_CLOSURES
        part = {"c": 0.0, "s": 0.0}  # the first k closures' largest relative deviations, for the log
        for (c2, s2), (c1, s1) in zip(run["hists"], want_hists):
            agree = torch.allclose(c2[:k], c1[:k], rtol=5e-2, atol=1e-12) and torch.allclose(s2[:k], s1[:k], rtol=s_rtol)
            if not agree:
                raise AssertionError(f"{where}: the first {k} closures' losses part: c {c2[:k].tolist()} / "
                                     f"{c1[:k].tolist()}, s {s2[:k].tolist()} / {s1[:k].tolist()}")
            for n, (a, b) in (("c", (c2, c1)), ("s", (s2, s1))):
                dev = ((a[:k].double() - b[:k].double()).abs() / b[:k].double().abs().clamp_min(1e-30)).max()
                part[n] = max(part[n], dev.item())
        rate = next(k for k in want_log if k.endswith("stylized_images_per_min"))
        pipe = next(k for k in want_log if k.endswith("pipeline_images_per_min"))
        final = {f"first {k} closures' relative deviation": part,
                 "c": (run["hists"][0][0][-1].item(), want_hists[0][0][-1].item()),
                 "s": (run["hists"][0][1][-1].item(), want_hists[0][1][-1].item()),
                 "stylized_images_per_min": (got_log[rate], want_log[rate]),
                 "pipeline_images_per_min": (got_log[pipe], want_log[pipe])}
    else:
        worst = _compare_metrics(where, got_log, want_log, _trainer_tol)
        final = {"train/steps_per_sec": (got_log["train/steps_per_sec"], want_log["train/steps_per_sec"])}
    for rank, counts in enumerate(every):
        have = {k: counts[name][k] for k in want_launches}
        if have != want_launches:
            raise AssertionError(f"{where}: rank {rank} of {len(every)} launched {counts[name]}; {want_launches} "
                                 "expected")
    _log(phase, f"{where}: metrics within tolerance of one process (largest deviation {worst:.3g}); ranks / one "
         f"process: {final}; each rank's launches {every[0][name]}; {run['wall']:.1f} s")


def phase_parallel(card: str, classifier: dict, gaze_log: dict) -> None:
    """The mains on ranks of a process group (``parallel/mesh.py``), every
    run with cuDNN's deterministic algorithms.

    NCCL, world size 1 (one spawned rank on cuda:0): the 2019 main at bs 64,
    MAIN_CLOSURES closures, stats taps on, bit-equal in every metric but
    its clocks, in every array and in its launches to the same main run in
    this process; the NST loop on the group under
    ``set_sync_debug_mode("error")``; closures/s without and with the group.

    gloo, world size 2, both ranks on cuda:0 (NCCL refuses two ranks on one
    card, so NCCL at two ranks and more is not run here): the 2019 and 2020
    mains against the same mains in this process, the classifier trainer
    with ``--model_parallel 2`` against phase_train2019's frozen run
    (``classifier``: launches and log) and the gaze trainer against
    phase_train_gaze's estimator-1 log.  The IST mains: every metric before
    the NST within 1e-4; over the first AGREEING_CLOSURES closures the style
    loss to rtol 1e-4 and the content loss to rtol 5e-2 (after the first,
    tiny step it is the squared distance of two nearly equal bf16 feature
    maps, rounding noise that another conv algorithm for another batch size
    moves by a few percent; a content loss not normalized over the whole
    batch, or a first step from one rank's |g|_1, would be off by the rank
    count or its square).  Then L-BFGS takes its first curvature pair from
    two nearly equal gradients of the twin's crops: the pair is rounding
    noise, and a batch split, which sums in another order, sends the loop
    on another trajectory; the NST losses and the post-NST metrics are then
    only required finite.  The trainers as :func:`_trainer_tol` holds them.
    Each rank's launches as derived for its half of the batch.

    gloo, world size 2 on cuda:0 as one model group (``--model_parallel
    2``): the 2019 main (stats taps on) and the 2020 main against the same
    runs in this process, as above but with the first closures' style
    losses to rtol 1e-5; each rank runs its data block (the whole batch)
    outside the NST and its slab of 112 rows in it, so its launches are
    one process's, and relu_stats' are derived as 4 x (closures + 2)
    forward and 4 x closures backward an NST call.  Then VGG19 split on H
    over the two ranks at (64, 3, 224, 224) bf16 (:func:`_vgg_split_errors`)."""
    import functools

    import numpy as np
    import torch
    from iris_style_transfer_tpu_torch.parallel import run_ranks
    from iris_style_transfer_tpu_torch.workloads import ist_openeds2019, ist_openeds2020
    from iris_style_transfer_tpu_torch.workloads.ist_openeds2020 import SEG_CHUNK

    t_phase = time.perf_counter()
    argv = IST_RUNS["ist2019"][0]
    with tempfile.TemporaryDirectory() as tmp:
        one = {"ist2019": _nodata_main(ist_openeds2019, argv, os.path.join(tmp, "plain2019")),
               "ist2020": _nodata_main(ist_openeds2020, IST_RUNS["ist2020"][0], os.path.join(tmp, "plain2020"))}
        base = one["ist2019"]
        got = run_ranks(functools.partial(_rank_nccl_world1, argv, tmp), 1, devices=["cuda:0"], backend="nccl",
                        timeout=PARALLEL_JOIN_S)
        if got["mesh"] != {"data": 1, "model": 1} or got["backend"] != "nccl":
            raise AssertionError(f"the group of one formed the mesh {got['mesh']} on {got['backend']}")
        log, log1 = (r["results"][IST_RUNS["ist2019"][1]] for r in (base, got))
        differ = [k for k in log if not k.endswith(TIMING_KEYS) and log1[k] != log[k]]
        differ += [n for n in base["arrays"] if not np.array_equal(got["arrays"].get(n), base["arrays"][n])]
        differ += [f"NST call {i}" for i, (a, b) in enumerate(zip(base["hists"], got["hists"]))
                   if not (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]))]
        if differ or got["arrays"].keys() != base["arrays"].keys() or got["launches"] != base["launches"]:
            raise AssertionError(f"the 2019 main on an NCCL group of one differs from one process in {differ}; "
                                 f"launches {got['launches']} against {base['launches']}")
        r = {k: float(np.mean(v)) for k, v in got["rates"].items()}
        _log("parallel", f"NCCL world size 1: the 2019 main (bs 64, {MAIN_CLOSURES} closures, stats taps on) "
             f"bit-equal to one process in {len(log)} metrics, {len(base['arrays'])} arrays and the NST "
             f"histories, launches {base['launches']}; NST (64,3,224,224) stats taps, {PARALLEL_NST_CLOSURES} "
             f"closures, no host sync on the group: {r['plain']:.2f} closures/s without the group, "
             f"{r['group']:.2f} with it ({100 * (r['group'] / r['plain'] - 1):+.1f}%; runs in turns "
             f"{got['rates']}) on {card}")

        t0 = time.perf_counter()
        two, every, split, split_s = run_ranks(functools.partial(_rank_gloo_mains, tmp), 2,
                                               devices=["cuda:0", "cuda:0"], backend="gloo", timeout=PARALLEL_JOIN_S)
        wall = time.perf_counter() - t0
    for name in ("ist2019", "ist2020", "classifier", "gaze", "spatial_ist2019", "spatial_ist2020"):
        main = name.removeprefix("spatial_")
        if main in IST_RUNS:
            want = dict(one[main]["launches"])
            if name == "ist2020":  # half the batch a rank; a model rank runs its data block whole, as one process
                want["dw_conv_bn_silu"] = _dw_launches(128 // 2, SEG_CHUNK)
            if name == "spatial_ist2019":  # the slab's count derived: 4 taps x (closures + 2) forward, x closures back
                calls = len(one[main]["hists"])
                derived = {"relu_stats_fwd": 4 * (MAIN_CLOSURES + 2) * calls,
                           "relu_stats_bwd": 4 * MAIN_CLOSURES * calls}
                if any(want[k] != v for k, v in derived.items()):
                    raise AssertionError(f"one process launched {want}; relu_stats {derived} derived")
            base = (one[main]["results"][IST_RUNS[main][1]], want, one[main]["hists"])
        elif name == "classifier":
            base = (classifier["log"], classifier["launches"], None)
        else:  # estimator 1 on the twin's landmarks: none of the counted kernels
            base = (gaze_log, {k: 0 for k in every[0]["gaze"]}, None)
        where = f"gloo world size 2 on one card, {name}" + (", data 1 x model 2" if main != name else "")
        _check_ranks("parallel", where, name, two[name], every, *base, s_rtol=1e-4 if main == name else 1e-5)
    worst = {k: max(e[k] for e in split) for k in split[0]}
    if not all(v <= SPLIT_REL_TOL for v in worst.values()):
        raise AssertionError(f"VGG19 split on H over 2 ranks differs from one process: {worst} (of each tensor's "
                             f"largest magnitude; {SPLIT_REL_TOL:g} allowed)")
    _log("parallel", f"VGG19 (64,3,224,224) bf16 split on H over 2 gloo ranks: taps, stats taps and input "
         f"gradients on each slab within {max(worst.values()):.3g} of the one-process tensors' largest "
         f"magnitude (allowed {SPLIT_REL_TOL:g}): {json.dumps({k: float(f'{v:.3g}') for k, v in worst.items()})}; "
         f"{split_s:.1f} s")
    _log("parallel", f"phase took {time.perf_counter() - t_phase:.1f} s (the two-rank runs {wall:.1f} s) on {card}")


def _rank_cards(tmp: str, n: int) -> list:
    """One of ``n`` NCCL ranks, rank r on cuda:r: the 2019 and 2020 mains
    and the classifier trainer over data (n/2) x model (2), each with
    ``--n_devices n`` at the one-card phases' arguments; then the stats-tap
    NST loop at a joint bs 64 (64/n a rank) under the sync check.  Returns
    rank 0's runs and closures/s, and every rank's launches."""
    import torch.distributed as dist
    from iris_style_transfer_tpu_torch.parallel import make_mesh
    from iris_style_transfer_tpu_torch.workloads import iris_classification, ist_openeds2019, ist_openeds2020

    _train_twin(iris_classification)
    runs = {"ist2019": (ist_openeds2019, IST_RUNS["ist2019"][0]), "ist2020": (ist_openeds2020, IST_RUNS["ist2020"][0]),
            "classifier": (iris_classification, [*CLASSIFIER_ARGS, "--model_parallel", "2"])}
    out = {}
    for name, (wl, argv) in runs.items():
        t0 = time.perf_counter()
        out[name] = _nodata_main(wl, [*argv, "--n_devices", str(n)], os.path.join(tmp, name), arrays=False)
        out[name]["wall"] = time.perf_counter() - t0
    rate = _nst_loop({"stats_taps": True, "mesh": make_mesh()}, (64, 3, 224, 224), PARALLEL_NST_CLOSURES,
                     SEED + 1)[0]
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, {k: v["launches"] for k, v in out.items()})
    return [out, every, rate, _rank_layouts() if n == 4 else None]


# --cards 4: the NST loop (stats taps) at each joint batch over each
# (data, model) layout of four cards, and on the multislice meshes
CARD_LAYOUTS = ((1, 4), (2, 2), (4, 1))
LAYOUT_BATCHES = (4, 64)
LAYOUT_CLOSURES = 50
HALO_TRACE_CLOSURES = 3


def _rank_layouts() -> dict:
    """One of four NCCL ranks: closures/s and the first closure's s_loss
    of the NST loop at each of LAYOUT_BATCHES on each of CARD_LAYOUTS and on
    ``make_multislice_mesh(2)`` and ``(2, model_parallel=2)``; for each
    layout with a model group, every rank's :func:`_halo_split` (the
    ``all_gather`` kernels are a closure's only ones, and their device time
    holds NCCL's wait for the last rank), traced once on every rank so
    that no rank retries a collective the others do not."""
    import functools

    import torch.distributed as dist
    from iris_style_transfer_tpu_torch.parallel import make_mesh, make_multislice_mesh

    meshes = {f"data {d} x model {m}": functools.partial(make_mesh, model_parallel=m) for d, m in CARD_LAYOUTS}
    meshes["multislice 2 x data 2 x model 1"] = functools.partial(make_multislice_mesh, 2)
    meshes["multislice 2 x data 1 x model 2"] = functools.partial(make_multislice_mesh, 2, model_parallel=2)
    out = {}
    for name, make in meshes.items():
        mesh = make()
        for bs in LAYOUT_BATCHES:
            shape = (bs, 3, 224, 224)
            rate, _, s_hist = _nst_loop({"stats_taps": True, "mesh": mesh}, shape, LAYOUT_CLOSURES, SEED + 1)
            halo = [None] * dist.get_world_size()
            dist.all_gather_object(halo, _halo_split(mesh, shape) if mesh.shape["model"] > 1 else None)
            out[(name, bs)] = {"rate": rate, "s0": s_hist[0].item(), "halo": halo}
    return out


def _halo_split(mesh, shape) -> dict:
    """One torch.profiler trace (host and device) of HALO_TRACE_CLOSURES
    closures on this rank's block of ``shape``, in ms a closure: the
    traced wall time, the host time inside the halo exchanges' spans
    (``halo_rows``, ``halo_rows_backward``) and the device time of the
    ``all_gather`` kernels (None when the trace holds none)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from iris_style_transfer_tpu_torch.models import VGG19
    from iris_style_transfer_tpu_torch.parallel import spatial_sharding
    from iris_style_transfer_tpu_torch.transfer.nst import make_nst_fn

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    params = VGG19.init(torch.Generator().manual_seed(SEED), device="cuda")
    block = spatial_sharding(mesh, shape)
    c, s = (torch.rand(shape, generator=gen, device="cuda")[block].contiguous() for _ in range(2))
    fn = make_nst_fn(epochs=HALO_TRACE_CLOSURES, compute_dtype=torch.bfloat16, lbfgs_dtype=torch.bfloat16,
                     stats_taps=True, mesh=mesh)
    fn(params, c, s)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn(params, c, s)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ev = prof.key_averages()
    host = sum(e.cpu_time_total for e in ev if e.key in ("halo_rows", "halo_rows_backward"))
    gathers = [e for e in _device_events(ev) if "allgather" in e.key.lower()]
    n = HALO_TRACE_CLOSURES
    return {"wall_ms": wall * 1e3 / n, "host_ms": host / 1e3 / n,
            "gather_ms": sum(e.self_device_time_total for e in gathers) / 1e3 / n if gathers else None}


def phase_cards(card: str, n: int) -> None:
    """``python3 chip_smoke.py --cards N`` on a host of N cards (N even):
    NCCL across the cards, which the one-card run cannot reach.  The 2019
    and 2020 mains and the classifier trainer (its heads split over 2 of
    the ranks) on N ranks, against the same runs on one card in this
    process, as :func:`phase_parallel` holds them; each rank's launches
    as derived for its block; stylized and pipeline images/min, train
    steps/s and the NST loop's closures/s at a joint bs 64 beside one
    card's.  On four cards, :func:`_rank_layouts`' layouts and multislice
    meshes beside one card (:func:`_log_layouts`)."""
    import functools

    from iris_style_transfer_tpu_torch.parallel import run_ranks
    from iris_style_transfer_tpu_torch.workloads import iris_classification, ist_openeds2019, ist_openeds2020
    from iris_style_transfer_tpu_torch.workloads.ist_openeds2020 import SEG_CHUNK

    t_phase = time.perf_counter()
    real_twin = iris_classification.synthetic_openeds2019
    with tempfile.TemporaryDirectory() as tmp:
        _train_twin(iris_classification)
        try:
            one = {"ist2019": _nodata_main(ist_openeds2019, IST_RUNS["ist2019"][0], os.path.join(tmp, "one2019")),
                   "ist2020": _nodata_main(ist_openeds2020, IST_RUNS["ist2020"][0], os.path.join(tmp, "one2020")),
                   "classifier": _nodata_main(iris_classification, CLASSIFIER_ARGS, os.path.join(tmp, "onecls"))}
        finally:
            iris_classification.synthetic_openeds2019 = real_twin
        rate1 = _nst_loop({"stats_taps": True}, (64, 3, 224, 224), PARALLEL_NST_CLOSURES, SEED + 1)[0]
        one_card = {bs: _nst_loop({"stats_taps": True}, (bs, 3, 224, 224), LAYOUT_CLOSURES, SEED + 1)
                    for bs in LAYOUT_BATCHES}
        out, every, rate, layouts = run_ranks(functools.partial(_rank_cards, tmp, n), n, backend="nccl",
                                              timeout=PARALLEL_JOIN_S)
    for name in ("ist2019", "ist2020", "classifier"):
        want = dict(one[name]["launches"])
        if name == "ist2020":
            want["dw_conv_bn_silu"] = _dw_launches(128 // n, SEG_CHUNK)
        log = one[name]["results"][IST_RUNS[name][1]] if name in IST_RUNS else one[name]["results"]
        _check_ranks("cards", f"NCCL, {n} cards, {name}", name, out[name], every, log, want, one[name]["hists"])
    _log("cards", f"NST (64,3,224,224) stats taps, {PARALLEL_NST_CLOSURES} closures, no host sync: {rate:.2f} "
         f"closures/s on {n} cards ({64 // n} images a card), {rate1:.2f} on one card ({rate / rate1:.2f}x) on {card}")
    if layouts is None:
        _log("cards", f"the (data, model) layouts and the multislice meshes need 4 cards; {n} here")
    else:
        _log_layouts(card, one_card, layouts)
    _log("cards", f"phase took {time.perf_counter() - t_phase:.1f} s on {n} x {card}")


# the first closure's s_loss of a layout against one card's: the same images
# and weights, the style statistics summed in another order and, on a model
# group, the slabs' bf16 convs perhaps by other cuDNN algorithms
LAYOUT_S0_RTOL = 1e-2


def _halo_text(halo: list) -> str:
    """Every rank's :func:`_halo_split` as ranges over the ranks."""
    if halo[0] is None:
        return "none (no model group)"

    def span(key):
        vals = [h[key] for h in halo if h[key] is not None]
        if not vals:
            return "not measured"
        shares = [100 * h[key] / h["wall_ms"] for h in halo if h[key] is not None]
        return f"{min(vals):.3f}-{max(vals):.3f} ({min(shares):.1f}-{max(shares):.1f}%)"

    walls = [h["wall_ms"] for h in halo]
    return (f"(traced, ranks' range, of {min(walls):.3f}-{max(walls):.3f} ms a closure): host "
            f"{span('host_ms')}, all_gather kernels {span('gather_ms')}")


def _log_layouts(card: str, one_card: dict, layouts: dict) -> None:
    """One line per layout and joint batch: closures/s against one card's,
    the halo exchanges' share of a closure, the first closure's s_loss
    against one card's (within LAYOUT_S0_RTOL, else the phase fails)."""
    bad = []
    for (name, bs), r in layouts.items():
        rate1, s1 = one_card[bs][0], one_card[bs][2][0].item()
        dev = abs(r["s0"] / s1 - 1)
        if not dev <= LAYOUT_S0_RTOL:
            bad.append(f"{name} bs {bs}: s_loss {r['s0']} against {s1} on one card")
        _log("cards", f"NST stats taps, joint bs {bs}, {name}: {r['rate']:.2f} closures/s against {rate1:.2f} on "
             f"one card ({r['rate'] / rate1:.2f}x), {LAYOUT_CLOSURES} closures; halo exchange a closure "
             f"{_halo_text(r['halo'])}; closure 0 s_loss within {dev:.2g} of one card's; {card}")
    if bad:
        raise AssertionError("layouts part from one card: " + "; ".join(bad))


def main_cards(n: int) -> int:
    """The entry of ``--cards N``: the device and build phases, then
    :func:`phase_cards`; the same last lines as :func:`main`."""
    smi = phase_device()
    import torch

    if torch.cuda.device_count() < n or n % 2:
        raise SystemExit(f"--cards {n} needs an even number of cards; this host has {torch.cuda.device_count()}")
    phase_build()
    phase_cards(smi.replace(",", " |"), n)
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


def main() -> int:
    t_start = time.perf_counter()
    smi = phase_device()
    import torch

    card = smi.replace(",", " |")
    phase_build()
    from iris_style_transfer_tpu_torch.workloads.ist_openeds2020 import SEG_CHUNK

    k = phase_kernels(card)
    kd = phase_kernels_depthwise(card, SEG_CHUNK)
    ks = phase_kernels_relu_stats(card)
    kg = phase_kernels_gram(card)
    kc = phase_kernels_conv1(card)
    kcc = phase_connected(card)
    _, c_hist, s_hist = phase_nst(card)
    _, c_hist_st, s_hist_st = phase_nst(card, stats_taps=True)
    _compare_histories(s_hist, s_hist_st)
    phase_nst_gram(card)
    launches = phase_main(card)
    launches_st = phase_main(card, stats_taps=True)
    launches2020 = phase_main2020(card, kd["b7_apply_ms"])
    launches2020_st = phase_main2020(card, kd["b7_apply_ms"], stats_taps=True)
    gram_launches = phase_demos(card)
    train = phase_train2019(card)
    gaze = phase_train_gaze(card)
    phase_real_data(card)
    phase_replicate(card)
    phase_parallel(card, train["frozen"], gaze["estimator1"]["log"])
    src = "iris_style_transfer_tpu_torch/ops/csrc/"
    stats_fwd = launches_st["relu_stats_fwd"] + launches2020_st["relu_stats_fwd"]
    stats_bwd = launches_st["relu_stats_bwd"] + launches2020_st["relu_stats_bwd"]
    def row(name, source, replaces, launches, err, ms, plain_ms, bound, library_ms):
        return {"name": name, "route": "cuda", "source": src + source,
                "replaces": "iris_style_transfer_tpu/ops/" + replaces, "launches": launches, "max_abs_err": err,
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bound[0], "bound_by": bound[1], "library_ms": library_ms}

    report = {"kernels": [
        row("relu_pool_fwd", "relu_pool.cu", "pallas_pool_paired.py:640", launches["relu_pool_fwd"], k["err_fwd"],
            k["fwd"], k["fwd_plain"], k["bound_fwd"], k["fwd_lib"]),
        row("relu_pool_bwd", "relu_pool.cu", "pallas_pool_paired.py:652", launches["relu_pool_bwd"], k["err_bwd"],
            k["bwd"], k["bwd_plain"], k["bound_bwd"], None),
        row("dw_conv_bn_silu", "depthwise.cu", "pallas_depthwise.py:136", launches2020["dw_conv_bn_silu"],
            kd["err"], kd["ms"], kd["plain_ms"], kd["bound"], kd["library_ms"]),
        row("gram_matrix", "gram.cu", "pallas_gram.py:51", gram_launches, kg["err"], kg["ms"], kg["plain_ms"],
            kg["bound"], kg["library_ms"]),
        row("relu_stats_fwd", "relu_stats.cu", "pallas_relu_stats.py:159", stats_fwd, ks["err_fwd"], ks["fwd"],
            ks["fwd_plain"], ks["bound_fwd"], None),
        row("relu_stats_bwd", "relu_stats.cu", "pallas_relu_stats.py:175", stats_bwd, ks["err_bwd"], ks["bwd"],
            ks["bwd_plain"], ks["bound_bwd"], None),
        row("conv1", "conv1.cu", "pallas_conv1.py:143", train["frozen"]["launches"]["conv1"], kc["err"], kc["ms"],
            kc["plain_ms"], kc["bound"], kc["library_ms"]),
        row("connected_components", "connected.cu",
            "connected.py:20 connected_components (a lax.while_loop of min-label propagation, not a Pallas kernel)",
            kcc["launches"], kcc["err"], kcc["ms"], kcc["plain_ms"], kcc["bound"], None),
    ]}
    _log("done", f"chip_smoke.py took {time.perf_counter() - t_start:.1f} s")
    print(json.dumps(report))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main_cards(int(sys.argv[2])) if sys.argv[1:2] == ["--cards"] else main())
