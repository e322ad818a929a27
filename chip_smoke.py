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
               at every distinct B7 shape of a 400x640 chunk, conv1 within
               one bf16 ulp (f32: 1e-5 of max|y|, also against an f64 conv;
               ``ops/conv1.py``) at the 224-px bs-64 and 512-px bs-4 conv1_1
               shapes and odd ones with C_in 1, 3 and 4; times each
               against its plain version and, where one PyTorch call
               computes the same function, that call, in turns; checks
               with torch.profiler and the launch counts that a VGG19
               forward (+backward, plain and with stats taps), a Gram-loss
               closure and a B7 U-Net apply launch them.
  4. nst     — the production NST loop (bf16 compute, bf16 L-BFGS history,
               m = 10) at (64, 3, 224, 224) on seeded VGG19 weights, once
               with the classic BN taps and once with the stats taps (their
               s_loss histories compared); then the Gram-loss loop at
               (4, 3, 512, 512).  After one warm-up closure each loop runs
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
    from iris_style_transfer_tpu_torch.ops import blockwise_gram, conv1, cuda_build, depthwise, relu_pool, relu_stats

    t0 = time.perf_counter()
    mods = (relu_pool, depthwise, relu_stats, blockwise_gram, conv1)
    with ThreadPoolExecutor(max_workers=len(mods)) as pool:  # one nvcc per source, together
        for f in [pool.submit(m._library) for m in mods]:
            f.result()
    for m in mods:
        info = cuda_build.BUILD_INFO[m.SOURCE]
        regs = [ln.strip() for ln in info["log"].splitlines() if "registers" in ln]
        _log("build", f"{m.SOURCE}: nvcc {info['seconds']:.1f} s; " + " | ".join(regs))
    _log("build", f"all kernels built and loaded in {time.perf_counter() - t0:.1f} s")


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
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fwd_bwd()
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages()]
    for k in ("relu_pool_fwd_kernel", "relu_pool_bwd_kernel"):
        hits = [n for n in names if k in n]
        if not hits:
            raise AssertionError(f"{k} absent from the profiler trace of a VGG19 forward+backward")
    device_us = sum(getattr(e, "self_device_time_total", 0) for e in prof.key_averages()
                    if any(k in e.key for k in ("relu_pool_fwd_kernel", "relu_pool_bwd_kernel")))
    _log("kernels", f"profiler: relu_pool_fwd_kernel and relu_pool_bwd_kernel traced in one VGG19 "
         f"fwd+bwd at (64,3,224,224) bf16 ({device_us / 1000:.3f} ms device time)")
    return {"err_fwd": err_f, "err_bwd": err_b, "bound_fwd": bound_f, "bound_bwd": bound_b, **ms}


def _b7_depthwise_shapes():
    """Distinct (k, C, H, W) of the stride-1 MBConv depthwise convs of one
    B7 forward on a 416x640 padded frame, and how many blocks take each."""
    from iris_style_transfer_tpu_torch.models.efficientnet import BLOCK_ARGS

    h, w = 208, 320  # after the stride-2 stem
    shapes: dict[tuple[int, int, int, int], int] = {}
    for e, k, s, cin, _ in BLOCK_ARGS:
        if s == 1:
            shapes[(k, cin * e, h, w)] = shapes.get((k, cin * e, h, w), 0) + 1
        else:
            h, w = -(-h // 2), -(-w // 2)
    if sum(shapes.values()) != 51:
        raise AssertionError(f"expected 51 stride-1 depthwise blocks in B7, got {sum(shapes.values())}")
    return shapes


def _dw_inputs(shape_nhwc, k, dtype, gen):
    """Random x, weight, and folded-BN a (away from 1) and b (away from 0)."""
    import torch

    b, h, w, c = shape_nhwc
    x = torch.randn(shape_nhwc, generator=gen, device="cuda").to(dtype).permute(0, 3, 1, 2)
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


def phase_kernels_depthwise(card: str, chunk: int):
    """dw_conv_bn_silu against its plain version at every B7 shape of a
    chunk, timing in turns, and a profiler proof on one B7 U-Net apply."""
    import torch
    from iris_style_transfer_tpu_torch.models import EfficientNet
    from iris_style_transfer_tpu_torch.ops import depthwise as dw

    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    cases = [((chunk, h, w, c), k, torch.bfloat16, n) for (k, c, h, w), n in _b7_depthwise_shapes().items()]
    cases += [((chunk, 26, 40, 960), 5, torch.float32, 0), ((3, 13, 7, 40), 5, torch.float32, 0),
              ((3, 13, 7, 40), 5, torch.bfloat16, 0)]
    worst = 0.0
    for shape, k, dtype, n_blocks in cases:
        x, wt, a, bias = _dw_inputs(shape, k, dtype, gen)
        y_k = dw._kernel_fwd(x, wt, a, bias, k)
        y_p = dw.dw_conv_bn_silu_plain(x, wt, a, bias, k)
        torch.cuda.synchronize()
        ok, err = dw.within_tolerance(y_k, y_p)
        equal = (y_k == y_p).float().mean().item()
        scale = y_p.float().abs().max().item()
        if not ok:
            raise AssertionError(f"dw_conv_bn_silu kernel vs plain out of tolerance at {shape} k{k} {dtype}: "
                                 f"max_abs_err {err}, max|y| {scale}, equal {equal:.6f}")
        worst = max(worst, err)
        where = f"{n_blocks} B7 blocks" if n_blocks else "extra case"
        _log("kernels", f"dw {shape} k{k} {str(dtype)[6:]} ({where}): max_abs_err {err:.3g} "
             f"(max|y| {scale:.3g}), {100 * equal:.4f}% equal, within tolerance")
        del x, wt, a, bias, y_k, y_p

    # at the costliest shape
    x, wt, a, bias = _dw_inputs((chunk, 104, 160, 288), 3, torch.bfloat16, gen)
    ms = _turns({"plain": lambda: dw.dw_conv_bn_silu_plain(x, wt, a, bias, 3),
                 "kernel": lambda: dw._kernel_fwd(x, wt, a, bias, 3),
                 "library": lambda: torch.nn.functional.conv2d(x, wt, padding=1, groups=x.shape[1])})
    gbytes = 2 * x.numel() * x.element_size() / 1e9
    bound = _bound(_nbytes(x, x, wt, a, bias), 2 * 9 * x.numel())
    _log("kernels", f"dw ({chunk},104,160,288) k3 bf16 ms/call on {card}: kernel {ms['kernel']:.4f} "
         f"(plain {ms['plain']:.4f}, F.conv2d(groups=C) {ms['library']:.4f}, bound {bound[0]:.4f}); "
         f"{gbytes / ms['kernel']:.2f} TB/s of x read once + y written once")
    del x, wt, a, bias

    agree = _b7_card_vs_cpu()
    _log("kernels", f"B7 U-Net on the card (the kernel, f32, no TF32) vs the port's CPU path (the "
         f"plain version) at (2,48,64,1): logits max rel err {agree['logit_err']:.3g}, "
         f"labels {100 * agree['labels_equal']:.2f}% equal, classes {agree['classes']}")

    # one B7 U-Net apply (flip TTA) on a chunk of full frames launches the kernel 102 times
    params = EfficientNet.init(torch.Generator().manual_seed(SEED), device="cuda")
    frames = torch.rand((chunk, 400, 640, 1), generator=gen, device="cuda")

    def apply():
        with torch.no_grad():
            return EfficientNet.apply(params, frames, compute_dtype=torch.bfloat16)

    apply()
    torch.cuda.synchronize()
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.reset_peak_memory_stats()
    before = dw.LAUNCHES["dw_conv_bn_silu"]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        apply()
        torch.cuda.synchronize()
    launched = dw.LAUNCHES["dw_conv_bn_silu"] - before
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    events = [e for e in prof.key_averages() if "dw_conv_bn_silu_kernel" in e.key]
    traced = sum(e.count for e in events)
    if not events or launched != 102:
        raise AssertionError(f"one B7 apply: dw_conv_bn_silu_kernel traced {traced} times, counted "
                             f"{launched} launches; 102 expected")
    dw_us = sum(getattr(e, "self_device_time_total", 0) for e in events)
    all_us = sum(getattr(e, "self_device_time_total", 0) for e in prof.key_averages()
                 if getattr(e, "device_type", None) is not None and "cuda" in str(e.device_type).lower())
    apply_ms = min(_time_ms(apply, iters=3) for _ in range(2))
    _log("kernels", f"profiler: dw_conv_bn_silu_kernel traced {traced} times in one B7 U-Net apply at "
         f"({chunk},400,640,1) bf16 TTA ({dw_us / 1000:.3f} ms of {all_us / 1000:.3f} ms device time); "
         f"apply {apply_ms:.2f} ms; peak memory {peak_gb:.2f} GB on {card}")
    return {"err": worst, "ms": ms["kernel"], "plain_ms": ms["plain"], "library_ms": ms["library"],
            "bound": bound, "b7_apply_ms": apply_ms, "b7_peak_gb": peak_gb}


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
    from torch.profiler import ProfilerActivity, profile
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
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fwd_bwd()
        torch.cuda.synchronize()
    counted = {k: rs.LAUNCHES[k] - before[k] for k in before}
    traced = {k: sum(e.count for e in prof.key_averages() if f"{k}_kernel" in e.key) for k in before}
    if counted != {"relu_stats_fwd": 4, "relu_stats_bwd": 4} or min(traced.values()) == 0:
        raise AssertionError(f"one VGG19 fwd+bwd with stats taps counted {counted} launches and traced {traced} "
                             "kernels; 4 launches of each, each traced, expected")
    # the profiler has traced fewer relu_stats_fwd kernels than were launched;
    # every relu_stats event it keeps is listed, for the record
    keys = {e.key[:60]: e.count for e in prof.key_averages() if "relu_stats" in e.key}
    _log("kernels", f"one VGG19 fwd+bwd with stats taps at (64,3,224,224) bf16: {counted} launches counted, "
         f"profiler traced {traced}; its relu_stats events {keys}")
    return {"err_fwd": worst["fwd"], "err_bwd": worst["bwd"], **ms}


def phase_kernels_gram(card: str):
    """The Gram kernel against the plain bmm (TF32 off) at the Gram NST's
    512-px tap shapes and the 2019 relu1_1 shape, plus f32 and odd cases;
    times; and a profiler proof on one Gram-loss closure."""
    import torch
    from iris_style_transfer_tpu_torch.ops import blockwise_gram as bg

    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cases = [(sh, torch.bfloat16) for sh in TAPS_512 + (TAPS_2019[0],)]
        cases += [((4, 512, 64, 64), torch.float32), ((2, 130, 9, 7), torch.float32),
                  ((3, 5, 7, 9), torch.bfloat16)]
        worst = 0.0
        for shape, dtype in cases:
            b, c, h, w = shape
            x = torch.relu(torch.randn((b, h, w, c), generator=gen, device="cuda")).to(dtype).permute(0, 3, 1, 2)
            g_k = bg._kernel_gram(x)
            g_p = bg.gram_matrix_plain(x)
            g64 = bg.gram_f64(x)
            torch.cuda.synchronize()
            # the f64 Gram is the tight witness, the TF32-off bmm the second one
            ok64, e_k = bg.within_f64_tolerance(g_k, g64)
            ok, err = bg.within_tolerance(g_k, g_p)
            e_p = bg.within_f64_tolerance(g_p, g64)[1]
            scale = g64.abs().max().item()
            if not (ok64 and ok):
                raise AssertionError(f"gram kernel out of tolerance at {shape} {dtype}: vs f64 {e_k} "
                                     f"(bound 1e-5 * {scale}), vs plain {err} (bound 1e-4 * max|G|)")
            worst = max(worst, err)
            _log("kernels", f"gram {shape} {str(dtype)[6:]}: vs f64 max_abs_err {e_k:.3g} ({e_k / scale:.3g} "
                 f"of max|G| {scale:.4g}, within 1e-5); vs plain {err:.3g} ({err / scale:.3g}, within 1e-4); "
                 f"plain vs f64 {e_p / scale:.3g}")
            del x, g_k, g_p, g64
        ms = {}
        for shape in (TAPS_2019[0], TAPS_512[0]):
            b, c, h, w = shape
            x = torch.relu(torch.randn((b, h, w, c), generator=gen, device="cuda")).to(torch.bfloat16)
            xf = x.reshape(b, h * w, c)  # the NHWC bytes as (B, HW, C), for the library bmm
            x = x.permute(0, 3, 1, 2)
            t = _turns({"plain": lambda: bg.gram_matrix_plain(x), "kernel": lambda: bg._kernel_gram(x),
                        "library": lambda: torch.bmm(xf.transpose(1, 2), xf)})
            gflop = 2 * b * h * w * c * c / 1e9
            t["bound"] = _bound(_nbytes(x) + b * c * c * 4, gflop * 1e9)
            _log("kernels", f"gram {shape} bf16 ms/call on {card}: kernel {t['kernel']:.4f} (plain "
                 f"{t['plain']:.4f}, bf16 torch.bmm {t['library']:.4f}, bound {t['bound'][0]:.4f}); "
                 f"{gflop / t['kernel']:.2f} TFLOP/s of the {gflop:.2f} GFLOP contraction")
            ms[shape] = t
            del x, xf
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32

    # the path launches it: one Gram-loss closure at (4, 3, 512, 512) bf16
    from torch.profiler import ProfilerActivity, profile
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

    closure()
    torch.cuda.synchronize()
    before = bg.LAUNCHES["gram_matrix"]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        closure()
        torch.cuda.synchronize()
    counted = bg.LAUNCHES["gram_matrix"] - before
    traced = sum(e.count for e in prof.key_averages() if "gram_kernel" in e.key)
    if counted != 4 or traced == 0:
        raise AssertionError(f"one Gram-loss closure counted {counted} gram launches and traced gram_kernel "
                             f"{traced} times; 4 launches, traced, expected")
    _log("kernels", f"one Gram-loss closure at (4,3,512,512) bf16: {counted} gram launches counted, profiler "
         f"traced gram_kernel {traced} times")
    return {"err": worst, "ms": ms[TAPS_512[0]]["kernel"], "plain_ms": ms[TAPS_512[0]]["plain"],
            "library_ms": ms[TAPS_512[0]]["library"], "bound": ms[TAPS_512[0]]["bound"],
            "ms_2019": ms[TAPS_2019[0]]["kernel"], "plain_ms_2019": ms[TAPS_2019[0]]["plain"]}


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
             ((3, 4, 13, 29), 40, torch.bfloat16, "C_in 4, C_out 40")]
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

    x, wt, bias = _conv1_inputs((64, 3, 224, 224), 64, torch.bfloat16, gen)
    w16, b16 = wt.to(torch.bfloat16), bias.to(torch.bfloat16)
    ms = _turns({"plain": lambda: c1.conv1_fwd_plain(x, wt, bias), "kernel": lambda: c1._kernel_fwd(x, wt, bias),
                 "library": lambda: F.conv2d(x, w16, b16, padding=1)})
    y = c1._kernel_fwd(x, wt, bias)
    flops = 2 * y.numel() * 9 * x.shape[1]
    ms["bound"] = _bound(_nbytes(x, y, w16, b16), flops)
    fma_ms = flops / PEAK_FLOPS["f32"] * 1e3
    _log("kernels", f"conv1 (64,3,224,224)->64 bf16 ms/call on {card}: kernel {ms['kernel']:.4f} (plain "
         f"{ms['plain']:.4f}, cuDNN F.conv2d {ms['library']:.4f}); bound {ms['bound'][0]:.4f} ms by "
         f"{ms['bound'][1]}, {flops / 1e9:.2f} GFLOP as f32 FMA on the CUDA cores {fma_ms:.4f} ms; "
         f"{_nbytes(x, y) / ms['kernel'] / 1e9:.2f} TB/s")
    del x, wt, bias, y

    from torch.profiler import ProfilerActivity, profile

    params = VGG19.init(torch.Generator().manual_seed(SEED), device="cuda")
    img = torch.rand((64, 3, 224, 224), generator=gen, device="cuda")
    with torch.no_grad():
        VGG19.apply(params, img, compute_dtype=torch.bfloat16)
        torch.cuda.synchronize()
        before = c1.LAUNCHES["conv1"]
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            VGG19.apply(params, img, compute_dtype=torch.bfloat16)
            torch.cuda.synchronize()
    traced = sum(e.count for e in prof.key_averages() if "conv1_kernel" in e.key)
    if traced == 0 or c1.LAUNCHES["conv1"] - before != 1:
        raise AssertionError(f"one VGG19 pass traced conv1_kernel {traced} times, counted "
                             f"{c1.LAUNCHES['conv1'] - before} launches; 1 launch, traced, expected")
    _log("kernels", f"one VGG19 forward at (64,3,224,224) bf16: 1 conv1 launch counted, profiler traced {traced}")
    return {"err": worst, "ms": ms["kernel"], "plain_ms": ms["plain"], "library_ms": ms["library"],
            "bound": ms["bound"]}


def _nst_loop(make_kw: dict, shape, closures: int, seed: int):
    """The NST loop at ``shape`` on seeded VGG19 weights; one warm-up
    closure, then ``closures`` under ``set_sync_debug_mode("error")``.
    Returns (closures/s, c_hist, s_hist); fails unless finite and s_loss
    falls."""
    import torch
    from iris_style_transfer_tpu_torch.models import VGG19
    from iris_style_transfer_tpu_torch.ops import conv1 as c1
    from iris_style_transfer_tpu_torch.transfer.nst import make_nst_fn

    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = VGG19.init(torch.Generator().manual_seed(SEED), device="cuda")
    c = torch.rand(shape, generator=gen, device="cuda")
    s = torch.rand(shape, generator=gen, device="cuda")
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


def phase_nst_gram(card: str):
    """The Gram-loss NST at bench.py's Gram secondary shape.  On seeded
    VGG19 weights the Gram loss is about 2.5e-7 at style weight 1, too
    small for an L-BFGS step to move a bf16 image; the style weight is the
    Gatys setting, 1e6."""
    rate, _, s_hist = _nst_loop({"bn_loss": False, "s_loss_weight": GRAM_STYLE_WEIGHT}, (4, 3, 512, 512),
                                GRAM_NST_CLOSURES, SEED + 6)
    _log("nst_gram", f"{GRAM_NST_CLOSURES} Gram-loss closures at (4,3,512,512) bf16, style weight "
         f"{GRAM_STYLE_WEIGHT:g}, no host sync: "
         f"{rate:.2f} closures/s; s_loss {s_hist[0].item():.6g} -> {s_hist[-1].item():.6g} on {card}")
    return rate


def _reset(counters) -> None:
    for counts in counters:
        for k in counts:
            counts[k] = 0


def _run_main(wl, argv: list[str], counters: tuple[dict, ...]):
    """``wl.main(argv)`` in a temporary directory, every count in
    ``counters`` set to 0 just before and read just after; also counts the
    NST calls.  Returns (results, launches, nst_calls, wall seconds)."""
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
            results = wl.main([*argv, "--data_dir", os.path.join(tmp, "no_data"), "--device", "cuda"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {k: v for counts in counters for k, v in counts.items()}
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
    log = main([*argv, "--device", "cuda"])
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
                out[name] = {"steps_per_sec": sps, "launches": launches, "peak_gb": peak}

            ckpt = os.path.join(tmp, "saved", "checkpoints", "iris_classification")
            if not os.path.exists(os.path.join(ckpt, "step_00000002.npz")):
                raise AssertionError(f"the trainer wrote no step_00000002.npz under {ckpt}")
            results = ist.main(["-bs", "64", "--nst_epochs", str(MAIN_CLOSURES), "-path1", ckpt, "-path2", ckpt,
                                *nodata, "--device", "cuda"])
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
                out[f"estimator{est}"] = {"steps_per_sec": sps, "peak_gb": peak}
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
    phase_train_gaze(card)
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
    ]}
    _log("done", f"chip_smoke.py took {time.perf_counter() - t_start:.1f} s")
    print(json.dumps(report))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
