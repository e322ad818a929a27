#!/usr/bin/env python3
"""End-to-end check that the PyTorch port runs on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each; any failure is an uncaught exception and a non-zero
exit:

  1. device  — CUDA must be available; prints the card's name and power
               limit as nvidia-smi reports them.
  2. build   — builds the hand-written kernels from ``ops/csrc`` with nvcc.
  3. kernels — each kernel against its plain torch version on the card,
               bit-exact, with planted ties, at the shapes the main path
               gives it and at two more; times both; checks with
               torch.profiler that a VGG19 forward+backward launches them.
  4. nst     — the production NST loop (bf16 compute, bf16 L-BFGS history,
               m = 10) at (64, 3, 224, 224) on seeded VGG19 weights; after
               one warm-up closure the loop runs under
               ``torch.cuda.set_sync_debug_mode("error")``, so a host sync
               inside it fails the run.
  5. main    — ``workloads.ist_openeds2019.main`` in-process on the
               synthetic twin at batch 64 and 20 NST closures; the kernels'
               launch counts are reset just before and read just after.

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
    from iris_style_transfer_tpu_torch.ops import cuda_build, relu_pool

    t0 = time.perf_counter()
    relu_pool._library()
    info = cuda_build.BUILD_INFO[relu_pool.SOURCE]
    regs = [ln.strip() for ln in info["log"].splitlines() if "registers" in ln]
    _log("build", f"{relu_pool.SOURCE}: nvcc {info['seconds']:.1f} s, load {time.perf_counter() - t0:.1f} s; "
         + " | ".join(regs))


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


def main() -> int:
    smi = phase_device()
    import torch

    card = smi.replace(",", " |")
    phase_build()
    k = phase_kernels(card)
    phase_nst(card)
    launches = phase_main(card)
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
    ]}
    print(json.dumps(report))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
