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
               the shapes the main paths give it and at more: relu_pool
               bit-exact with planted ties; dw_conv_bn_silu within its
               stated tolerance (``ops/depthwise.py``) at every distinct
               B7 shape of a 400x640 chunk in bf16, plus f32 and odd
               cases; times both; checks with torch.profiler that a VGG19
               forward+backward and one B7 U-Net apply launch them.
  4. nst     — the production NST loop (bf16 compute, bf16 L-BFGS history,
               m = 10) at (64, 3, 224, 224) on seeded VGG19 weights; after
               one warm-up closure the loop runs under
               ``torch.cuda.set_sync_debug_mode("error")``, so a host sync
               inside it fails the run.
  5. main    — ``workloads.ist_openeds2019.main`` in-process on the
               synthetic twin at batch 64 and 20 NST closures; the kernels'
               launch counts are reset just before and read just after.
  6. main2020 — ``workloads.ist_openeds2020.main`` in-process on the gaze
               twin (24 frames in one batch of 128, 400x640, B7 U-Net +
               ResNet50 + both estimators at full width, 20 closures);
               counts reset just before and read just after; the
               depthwise kernel must launch exactly 102 x (1 + 2 x 128 /
               SEG_CHUNK) times; then a timing breakdown of the batch body.

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

NST_CLOSURES = 200
SEED = 0


def _log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


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
    from iris_style_transfer_tpu_torch.ops import cuda_build, depthwise, relu_pool

    t0 = time.perf_counter()
    mods = (relu_pool, depthwise)
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

    # plain, kernel, kernel, plain: both in turns on the same card
    t = {"fwd_plain": [], "fwd": [], "bwd_plain": [], "bwd": []}
    for order in (("plain", "kernel"), ("kernel", "plain")):
        for which in order:
            if which == "plain":
                t["fwd_plain"].append(_time_ms(lambda: rp.relu_pool_fwd_plain(x)))
                t["bwd_plain"].append(_time_ms(lambda: rp.relu_pool_bwd_plain(x, y, ct)))
            else:
                t["fwd"].append(_time_ms(lambda: rp._kernel_fwd(x)))
                t["bwd"].append(_time_ms(lambda: rp._kernel_bwd(x, y, ct)))
    ms = {k: min(v) for k, v in t.items()}
    _log("kernels", f"(64,224,224,64) bf16 ms/call on {card}: fwd {ms['fwd']:.4f} (plain "
         f"{ms['fwd_plain']:.4f}), bwd {ms['bwd']:.4f} (plain {ms['bwd_plain']:.4f})")
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
    return {"err_fwd": err_f, "err_bwd": err_b, **ms}


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

    # plain, kernel, kernel, plain at the costliest shape
    x, wt, a, bias = _dw_inputs((chunk, 104, 160, 288), 3, torch.bfloat16, gen)
    t = {"plain": [], "kernel": []}
    for order in (("plain", "kernel"), ("kernel", "plain")):
        for which in order:
            fn = dw.dw_conv_bn_silu_plain if which == "plain" else dw._kernel_fwd
            t[which].append(_time_ms(lambda: fn(x, wt, a, bias, 3)))
    ms = {k: min(v) for k, v in t.items()}
    gbytes = 2 * x.numel() * x.element_size() / 1e9
    _log("kernels", f"dw ({chunk},104,160,288) k3 bf16 ms/call on {card}: kernel {ms['kernel']:.4f} "
         f"(plain {ms['plain']:.4f}); {gbytes / ms['kernel']:.2f} TB/s of x read once + y written once")
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
    return {"err": worst, "ms": ms["kernel"], "plain_ms": ms["plain"], "b7_apply_ms": apply_ms,
            "b7_peak_gb": peak_gb}


def phase_nst(card: str):
    import torch
    from iris_style_transfer_tpu_torch.models import VGG19
    from iris_style_transfer_tpu_torch.transfer.nst import make_nst_fn

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    params = VGG19.init(torch.Generator().manual_seed(SEED), device="cuda")
    c = torch.rand((64, 3, 224, 224), generator=gen, device="cuda")
    s = torch.rand((64, 3, 224, 224), generator=gen, device="cuda")
    kw = dict(compute_dtype=torch.bfloat16, lbfgs_dtype=torch.bfloat16, history_size=10)
    make_nst_fn(epochs=1, **kw)(params, c, s)  # warm-up closure
    torch.cuda.synchronize()
    fn = make_nst_fn(epochs=NST_CLOSURES, **kw)
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        res = fn(params, c, s)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    s_hist, c_hist = res.s_loss_hist.cpu(), res.c_loss_hist.cpu()
    if not (torch.isfinite(s_hist).all() and torch.isfinite(c_hist).all() and torch.isfinite(res.x).all()):
        raise AssertionError("NST loss history or image is not finite")
    if not s_hist[-1] < s_hist[0]:
        raise AssertionError(f"s_loss did not fall: {s_hist[0].item()} -> {s_hist[-1].item()}")
    _log("nst", f"{NST_CLOSURES} closures at (64,3,224,224) bf16 in {dt:.2f} s, no host sync: "
         f"{NST_CLOSURES / dt:.2f} closures/s, {64 * 60 / dt * NST_CLOSURES / 200:.1f} stylized "
         f"images/min at 200 closures; s_loss {s_hist[0].item():.6g} -> {s_hist[-1].item():.6g} "
         f"on {card}")
    return NST_CLOSURES / dt


def phase_main(card: str):
    import torch
    from iris_style_transfer_tpu_torch.ops import relu_pool as rp
    from iris_style_transfer_tpu_torch.workloads import ist_openeds2019 as wl

    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            for k in rp.LAUNCHES:
                rp.LAUNCHES[k] = 0
            results = wl.main(["-bs", "64", "--nst_epochs", "20", "--data_dir",
                               os.path.join(tmp, "no_data"), "--device", "cuda"])
            torch.cuda.synchronize()
            launches = dict(rp.LAUNCHES)
        finally:
            os.chdir(cwd)
    log = results[("test/", 1.0, 20)]
    keys = ["test/post/mean_miou", "test/stylized_images_per_min", "test/pipeline_images_per_min"]
    keys += [f"test/{p}/c{n}/{m}" for p in ("pre", "post") for n in (1, 2) for m in ("accu", "loss", "f1")]
    for k in keys:
        if k not in log or not math.isfinite(log[k]):
            raise AssertionError(f"workload metric {k} missing or not finite: {log.get(k)}")
    for k, n in launches.items():
        if n == 0:
            raise AssertionError(f"{k} was never launched by the workload main")
    _log("main", f"ist_openeds2019 bs 64, 20 closures on {card}: stylized_images_per_min "
         f"{log['test/stylized_images_per_min']:.1f}, pipeline_images_per_min "
         f"{log['test/pipeline_images_per_min']:.1f}, post mean_miou {log['test/post/mean_miou']:.4f}, "
         f"launches {launches}")
    return launches


def phase_main2020(card: str, b7_apply_ms: float):
    import torch
    from iris_style_transfer_tpu_torch.ops import depthwise as dw
    from iris_style_transfer_tpu_torch.ops import relu_pool as rp
    from iris_style_transfer_tpu_torch.workloads import ist_openeds2020 as wl

    bs, chunk = 128, wl.SEG_CHUNK
    want_dw = 102 * (1 + 2 * bs // chunk)  # the style iris, then pre and post per chunk
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            torch.cuda.reset_peak_memory_stats()
            for counts in (rp.LAUNCHES, dw.LAUNCHES):
                for k in counts:
                    counts[k] = 0
            t0 = time.perf_counter()
            results = wl.main(["-bs", str(bs), "--nst_epochs", "20", "--data_dir",
                               os.path.join(tmp, "no_data"), "--device", "cuda"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {**rp.LAUNCHES, **dw.LAUNCHES}
        finally:
            os.chdir(cwd)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log = results[("validation/", 1.0, 20)]
    keys = [f"validation//{p}/degree_distance{i}" for p in ("pre", "post") for i in (1, 2)]
    keys += ["validation//stylized_images_per_min", "validation//pipeline_images_per_min"]
    for k in keys:
        if k not in log or not math.isfinite(log[k]):
            raise AssertionError(f"workload metric {k} missing or not finite: {log.get(k)}")
    for k, n in launches.items():
        if n == 0:
            raise AssertionError(f"{k} was never launched by the 2020 main")
    if launches["dw_conv_bn_silu"] != want_dw:
        raise AssertionError(f"dw_conv_bn_silu launched {launches['dw_conv_bn_silu']} times in the 2020 "
                             f"main; 102 x (1 + 2 x {bs}/{chunk}) = {want_dw} expected")
    body_s = bs * 60 / log["validation//pipeline_images_per_min"]
    nst_s = bs * 60 / log["validation//stylized_images_per_min"]
    b7_s = 2 * (bs // chunk) * b7_apply_ms / 1000
    _log("main2020", f"ist_openeds2020 bs {bs}, 20 closures, chunk {chunk} on {card}: "
         f"degree_distance pre {log[keys[0]]:.2f}/{log[keys[1]]:.2f}, post {log[keys[2]]:.2f}/"
         f"{log[keys[3]]:.2f}; stylized_images_per_min {log[keys[4]]:.1f}, pipeline_images_per_min "
         f"{log[keys[5]]:.1f}; launches {launches}; main {wall:.1f} s; peak memory {peak_gb:.2f} GB")
    _log("main2020", f"batch body {body_s:.3f} s: NST {nst_s:.3f} s ({100 * nst_s / body_s:.1f}%), "
         f"B7 U-Net {2 * bs // chunk} chunk applies x {b7_apply_ms:.1f} ms = {b7_s:.3f} s "
         f"({100 * b7_s / body_s:.1f}%), rest {body_s - nst_s - b7_s:.3f} s")
    return launches


def main() -> int:
    smi = phase_device()
    import torch

    card = smi.replace(",", " |")
    phase_build()
    from iris_style_transfer_tpu_torch.workloads.ist_openeds2020 import SEG_CHUNK

    k = phase_kernels(card)
    kd = phase_kernels_depthwise(card, SEG_CHUNK)
    phase_nst(card)
    launches = phase_main(card)
    launches2020 = phase_main2020(card, kd["b7_apply_ms"])
    src = "iris_style_transfer_tpu_torch/ops/csrc/relu_pool.cu"
    report = {"kernels": [
        {"name": "relu_pool_fwd", "route": "cuda", "source": src,
         "replaces": "iris_style_transfer_tpu/ops/pallas_pool_paired.py:640",
         "launches": launches["relu_pool_fwd"], "max_abs_err": k["err_fwd"],
         "ms": k["fwd"], "plain_ms": k["fwd_plain"]},
        {"name": "relu_pool_bwd", "route": "cuda", "source": src,
         "replaces": "iris_style_transfer_tpu/ops/pallas_pool_paired.py:652",
         "launches": launches["relu_pool_bwd"], "max_abs_err": k["err_bwd"],
         "ms": k["bwd"], "plain_ms": k["bwd_plain"]},
        {"name": "dw_conv_bn_silu", "route": "cuda",
         "source": "iris_style_transfer_tpu_torch/ops/csrc/depthwise.cu",
         "replaces": "iris_style_transfer_tpu/ops/pallas_depthwise.py:136",
         "launches": launches2020["dw_conv_bn_silu"], "max_abs_err": kd["err"],
         "ms": kd["ms"], "plain_ms": kd["plain_ms"]},
    ]}
    print(json.dumps(report))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
