#!/usr/bin/env python3
"""Run the PyTorch port (stablemtl_tpu_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py             # all phases
    python3 chip_smoke.py --profile   # all phases, plus device time by
                                      # kernel over one step

Phases (any failure exits non-zero before the result line):
1. build the CUDA kernels from csrc/ (one nvcc per source, in parallel);
2. hold each kernel against its plain PyTorch version at the main path's
   shapes, a ragged S=1672 and the other presets' head dims, bf16 and f32,
   fast softmax on and off, and time it beside the plain version and
   torch's scaled_dot_product_attention (a yardstick the port never calls);
3. fused all-task inference at full SD2 width, 512x512, bf16, fast math,
   with launch counters reset before and read after; a second bf16 step
   holds every kernel call against the plain version on that call's own
   inputs; the output is held against the same pipeline with
   STABLEMTL_DISABLE_FLASH=1 (plain attention on the card) and against both
   paths on the same weights in f32, then timed at batch 1 and 2.

It prints the card's name and power limit from nvidia-smi, a JSON line
{"kernels": [...]}, and as its last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, HBM3, and
# the special-function units' exp2 rate (4 SFU ops/clk per SM quadrant,
# 132 SMs, 1.83 GHz boost).
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
PEAK_EXP2 = 132 * 16 * 1.83e9
# (max |err|, relative L2 ||err|| / ||ref||) by which a kernel may differ
# from its plain version. In bf16 both round p and o at the same points, so
# they differ by summation order and single output ulps: on the H100,
# max|err| <= 1.95e-3 (one ulp at |o| in [0.25, 0.5)) and relative L2
# <= 2.4e-3 on N(0, 1) inputs, whose outputs are ~0.026 (RMS). A kernel
# that skips one 64-key tile of 4096 measured 0.127 relative L2, one that
# drops the 8-key ragged tail at S=1672 0.071.
TOL = {"bfloat16": (4e-3, 5e-3), "float32": (2e-5, 1e-5)}
# Each flash call of a bf16 fast-softmax step, held against the plain
# version on its own inputs, in relative L2 (the path's activations have no
# fixed scale): measured <= 2.2e-4 per call; with one key tile skipped the
# calls measured 6.1e-3 to 5.5e-2.
PATH_CALL_REL_L2 = 2e-3
# Whole-path agreement. The flash path is held against plain attention on
# the same weights in f32, where both are exact up to f32 rounding: each
# kernel call differs from the plain math by <= 6e-7 (phase 2), and 22
# attention calls feeding residual streams amplify that; 5e-4 on outputs in
# [-1, 1] leaves several times the 8.1e-5 measured on the H100. In bf16
# with fast math, this random-weight network amplifies rounding to ~9 %
# relative L2 from f32 whichever attention runs, so the bf16 flash path is
# held to be no further from the f32 plain result than the bf16 plain path
# is (measured ratio 1.016), with 25 % of room. This ratio only catches a
# gross fault (with one key tile skipped it read 1.010);
# PATH_CALL_REL_L2 holds each kernel call on the bf16 path.
PATH_F32_MAX_ABS = 5e-4
PATH_BF16_RATIO = 1.25


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", flush=True)
    sys.exit(1)


def cuda_time(fn, iters: int, warmup: int = 1) -> float:
    """ms per call from CUDA events around `iters` calls."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def attention_bound_ms(bh: int, s: int, d: int, dtype) -> tuple:
    """Least time for softmax(q k^T) v on [bh, s, d]: the larger of the
    bytes (q, k, v read once, o written once) over HBM bandwidth and the
    operations (4*s*s*d FLOPs and s*s exp2 per head) over their peaks."""
    import torch

    item = torch.tensor([], dtype=dtype).element_size()
    t_bytes = 4 * bh * s * d * item / PEAK_BYTES
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS
    t_ops = max(4 * bh * s * s * d / peak, bh * s * s / PEAK_EXP2)
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes > t_ops else "operations")


def phase_build():
    from stablemtl_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    report = cuda_build.build()
    print(f"[build] {len(report)} source(s) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name, (secs, log) in report.items():
        print(f"[build] {name}: nvcc {secs:.1f} s", flush=True)
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[ptxas] {line.strip()}", flush=True)


def phase_kernels():
    """Check both kernels; return {kernel: measured stats at its main-path
    shape}."""
    import torch
    import torch.nn.functional as F

    from stablemtl_tpu_torch.ops.flash_attention import (flash_fwd_resident,
                                                         flash_fwd_stream,
                                                         flash_reference)

    gen = torch.Generator(device="cuda").manual_seed(0)
    # (kernel, shape, timed): the main path's shapes are timed, and the
    # first of each kernel is the one reported; the ragged eval geometry
    # and the other presets' head dims are checked only
    cases = [
        (flash_fwd_resident, (35, 4096, 64), True),   # stage 0: 7 x 5 heads
        (flash_fwd_resident, (70, 1024, 64), True),   # stage 1: 7 x 10 heads
        (flash_fwd_resident, (10, 1672, 64), False),  # ragged: 26 tiles + 8
        (flash_fwd_resident, (4, 1100, 32), False),   # small preset UNet
        (flash_fwd_resident, (4, 1100, 16), False),   # tiny preset UNet
        (flash_fwd_stream, (7, 4096, 512), True),     # VAE decode, 7 streams
        (flash_fwd_stream, (1, 4096, 512), True),     # VAE encode
        (flash_fwd_stream, (2, 1100, 256), False),    # small preset VAE
    ]
    stats = {}
    for kernel, shape, timed in cases:
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = (torch.randn(shape, generator=gen, device="cuda")
                       .to(dtype) for _ in range(3))
            tol_abs, tol_rel = TOL[str(dtype).split(".")[1]]
            for fast in (False, True):
                out = kernel(q, k, v, fast_softmax=fast)
                ref = flash_reference(q, k, v, fast_softmax=fast)
                err, rel = compare(out, ref)
                rms = ref.float().square().mean().sqrt().item()
                print(f"[check] {kernel.__name__} {shape} "
                      f"{str(dtype)[6:]} fast={int(fast)} "
                      f"max_abs={err:.3e} rel_l2={rel:.3e} "
                      f"(tol {tol_abs:g}, {tol_rel:g}; ref rms {rms:.3e})",
                      flush=True)
                if not (err <= tol_abs and rel <= tol_rel):
                    fail(f"{kernel.__name__} {shape} {dtype} fast={fast}"
                         f": max_abs {err:.3e}, rel_l2 {rel:.3e} over "
                         f"{tol_abs:g}, {tol_rel:g}")
            if dtype != torch.bfloat16 or not timed:
                continue
            # timing at the main path's dtype and softmax mode; the library
            # call takes [1, BH, S, d], the 4-D layout its fused back ends
            # need
            ms = cuda_time(lambda: kernel(q, k, v, fast_softmax=True), 10)
            plain_ms = cuda_time(
                lambda: flash_reference(q, k, v, fast_softmax=True), 3)
            lib_ms = cuda_time(
                lambda: F.scaled_dot_product_attention(
                    q[None], k[None], v[None]), 10)
            bound, bound_by = attention_bound_ms(*shape, dtype)
            print(f"[time] {kernel.__name__} {shape} bf16 fast: "
                  f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                  f"sdpa {lib_ms:.4f} ms, bound {bound:.4f} ms "
                  f"({bound_by})", flush=True)
            if kernel not in stats:
                stats[kernel] = dict(
                    shape=list(shape), max_abs_err=err, ms=ms,
                    plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by,
                    library_ms=lib_ms)
        del q, k, v
        torch.cuda.empty_cache()
    return stats


def phase_main_path(batch: int, profile: bool = False):
    """Returns the launch counts of one step at `batch`; then times steps
    at `batch` and twice that."""
    import torch

    from stablemtl_tpu_torch.factory import build_pipeline
    from stablemtl_tpu_torch.ops.flash_attention import (flash_fwd_resident,
                                                         flash_fwd_stream)

    os.environ["STABLEMTL_FAST_MATH"] = "1"  # the benchmarked workload
    t0 = time.perf_counter()
    pipe = build_pipeline("full", multi_stream=True, image_hw=(512, 512),
                          dtype="bfloat16", fast_math=True, seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for m in (pipe.vae, pipe.unet, pipe.unet_child)
                   for p in m.parameters())
    print(f"[path] full pipeline built in {time.perf_counter() - t0:.1f} s,"
          f" {n_params / 1e9:.3f} B parameters", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(1)
    rgb = torch.rand((batch, 512, 512, 3), generator=gen,
                     device="cuda") * 2 - 1

    flash_fwd_resident.launches = 0
    flash_fwd_stream.launches = 0
    t0 = time.perf_counter()
    out = pipe.infer_all_tasks(rgb, None)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    counts = {flash_fwd_resident: flash_fwd_resident.launches,
              flash_fwd_stream: flash_fwd_stream.launches}
    print(f"[path] first infer_all_tasks {first_s:.2f} s; launches: "
          f"flash_fwd_resident={counts[flash_fwd_resident]} "
          f"flash_fwd_stream={counts[flash_fwd_stream]}", flush=True)
    want_shape = (7, batch, 512, 512, 3)
    if tuple(out.shape) != want_shape:
        fail(f"output shape {tuple(out.shape)} != {want_shape}")
    if not torch.isfinite(out).all():
        fail("non-finite output")
    for kernel, n in counts.items():
        if n == 0:
            fail(f"{kernel.__name__} never launched on the main path")

    calls = run_checked_calls(pipe, rgb)
    for name, shape, max_abs, rel_l2 in calls:
        print(f"[path] bf16 call {name} {shape}: max_abs={max_abs:.4e} "
              f"rel_l2={rel_l2:.4e} (tol rel_l2 {PATH_CALL_REL_L2})",
              flush=True)
    plain = run_plain_attention(pipe, rgb)
    # the same weights in f32 (init draws in f32 before the bf16 cast):
    # flash and plain attention there, the kernels' f32 instances
    pipe32 = build_pipeline("full", multi_stream=True, image_hw=(512, 512),
                            dtype="float32", fast_math=True, seed=0)
    out32 = pipe32.infer_all_tasks(rgb, None)
    plain32 = run_plain_attention(pipe32, rgb)
    del pipe32
    torch.cuda.empty_cache()
    checks = [
        ("f32 flash vs f32 plain", compare(out32, plain32), PATH_F32_MAX_ABS),
        ("bf16 flash vs f32 plain", compare(out, plain32), None),
        ("bf16 plain vs f32 plain", compare(plain, plain32), None),
        ("bf16 flash vs bf16 plain", compare(out, plain), None),
    ]
    for name, (max_abs, rel_l2), tol in checks:
        print(f"[path] {name}: max_abs={max_abs:.4e} rel_l2={rel_l2:.4e}"
              + (f" (tol max_abs {tol})" if tol else ""), flush=True)
    print(f"[path] output mean={out.float().mean().item():.4e} "
          f"std={out.float().std().item():.4e}", flush=True)
    ratio = checks[1][1][1] / checks[2][1][1]
    print(f"[path] bf16 error ratio, flash over plain (against f32 plain): "
          f"{ratio:.4f} (tol {PATH_BF16_RATIO})", flush=True)

    for b in (batch, 2 * batch):
        time_steps(pipe, b)
    if profile:
        profile_step(pipe, rgb)
    if len(calls) != sum(counts.values()):
        fail(f"{len(calls)} flash calls checked, {sum(counts.values())} "
             f"launched on the main path")
    if not all(c[3] <= PATH_CALL_REL_L2 for c in calls):
        fail("a kernel call on the bf16 path disagrees with its plain "
             "version")
    if not checks[0][1][0] <= PATH_F32_MAX_ABS:
        fail("f32 flash path disagrees with f32 plain attention")
    if not ratio <= PATH_BF16_RATIO:
        fail("bf16 flash path is further from f32 than bf16 plain attention")
    return counts


def run_checked_calls(pipe, rgb):
    """infer_all_tasks with every flash call also run through the plain
    version on its own inputs. Returns [(kernel, q shape, max |err|,
    relative L2)] per call."""
    from stablemtl_tpu_torch.ops import attention
    from stablemtl_tpu_torch.ops import flash_attention as fa

    launch = attention.flash_attention
    calls = []

    def checked(q, k, v):
        out = launch(q, k, v)
        b, s, h, d = q.shape

        def fold(x):
            return x.permute(0, 2, 1, 3).reshape(b * h, s, d)

        ref = fa.flash_reference(fold(q), fold(k), fold(v),
                                 fa.fast_softmax())
        name = ("flash_fwd_resident" if d <= fa.RESIDENT_MAX_HEAD_DIM
                else "flash_fwd_stream")
        calls.append((name, tuple(q.shape),
                      *compare(fold(out), ref)))
        return out

    attention.flash_attention = checked
    try:
        pipe.infer_all_tasks(rgb, None)
    finally:
        attention.flash_attention = launch
    return calls


def run_plain_attention(pipe, rgb):
    """infer_all_tasks with STABLEMTL_DISABLE_FLASH=1: plain attention on
    the card."""
    os.environ["STABLEMTL_DISABLE_FLASH"] = "1"
    try:
        return pipe.infer_all_tasks(rgb, None)
    finally:
        del os.environ["STABLEMTL_DISABLE_FLASH"]


def compare(a, b) -> tuple:
    """(max |a - b|, ||a - b|| / ||b||) in f32."""
    diff = a.float() - b.float()
    return (diff.abs().max().item(),
            (diff.norm() / b.float().norm()).item())


def profile_step(pipe, rgb, top: int = 15):
    """Device time by kernel over one infer_all_tasks step (torch.profiler)
    and the device's idle share of the step's wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pipe.infer_all_tasks(rgb, None)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    print(f"[profile] step wall {wall_ms:.2f} ms (profiled), device busy "
          f"{busy_ms:.2f} ms, idle share {1 - busy_ms / wall_ms:.3f}",
          flush=True)
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"[profile] {e.self_device_time_total / 1e3:9.3f} ms "
              f"x{e.count:<5d} {e.key[:100]}", flush=True)


def time_steps(pipe, batch: int, iters: int = 3) -> float:
    """ms per infer_all_tasks step at `batch` (host clock around
    synchronized steps, after one warm-up step)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(2)
    rgb = torch.rand((batch, 512, 512, 3), generator=gen,
                     device="cuda") * 2 - 1
    out = pipe.infer_all_tasks(rgb, None)
    if tuple(out.shape) != (7, batch, 512, 512, 3) or \
            not torch.isfinite(out).all():
        fail(f"batch {batch}: output {tuple(out.shape)} not finite "
             f"[7, {batch}, 512, 512, 3]")
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        pipe.infer_all_tasks(rgb, None)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / iters * 1e3
    print(f"[path] infer_all_tasks batch {batch}: {step_ms:.2f} ms/step, "
          f"{batch / step_ms * 1e3:.4f} images/s (all 7 tasks), peak "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
          flush=True)
    return step_ms


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--profile", action="store_true",
                        help="also print device time by kernel for one "
                             "step (torch.profiler)")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import stablemtl_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script: {e}",
              file=sys.stderr)
        return 2

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    # f32 references in full f32 (the kernels' f32 path has no TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from stablemtl_tpu_torch.ops.flash_attention import (flash_fwd_resident,
                                                         flash_fwd_stream)

    phase_build()
    stats = phase_kernels()
    counts = phase_main_path(batch=1, profile=args.profile)

    # (source, the TPU kernel it replaces)
    meta = {
        flash_fwd_resident: ("stablemtl_tpu_torch/csrc/flash_fwd_a.cu",
                             "stablemtl_tpu/ops/flash_attention.py:258"),
        flash_fwd_stream: ("stablemtl_tpu_torch/csrc/flash_fwd_b.cu",
                           "stablemtl_tpu/ops/flash_attention.py:501"),
    }
    kernels = []
    for kernel, s in stats.items():
        kernels.append(dict(
            name=kernel.__name__, route="cuda", source=meta[kernel][0],
            replaces=meta[kernel][1], launches=counts[kernel],
            max_abs_err=s["max_abs_err"], ms=s["ms"],
            plain_ms=s["plain_ms"], bound_ms=s["bound_ms"],
            bound_by=s["bound_by"], library_ms=s["library_ms"],
            shape=s["shape"]))
    print(json.dumps({"kernels": kernels}), flush=True)
    if any(not math.isfinite(k["ms"]) for k in kernels):
        fail("non-finite timing")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
