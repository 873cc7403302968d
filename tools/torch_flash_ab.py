#!/usr/bin/env python3
"""The Hopper kernels of this tree against another tree's sources of them,
on one NVIDIA GPU: K1 (kernel A), K2 (kernel B), K3 (the training forward
with its logsumexp), K4 and K5 (the training backward: dQ; dK and dV) and
K6 (the fused GEGLU).

    python3 tools/torch_flash_ab.py --parent DIR [--rounds 1] [--no-steps]
        [--only LIB ...]

DIR is the root of another checkout (for example a `git archive` of the
parent commit unpacked into a git-ignored directory). Its
`stablemtl_tpu_torch/csrc/<name>.cu` for every name in NAMES (or those
named by --only) are built with this tree's nvcc flags and parts into the
build directory's `ab/` and loaded with ctypes beside this tree's
libraries. Both trees' entry points must share this tree's C signature
(the forward kernels' entry points took their variant arguments, poly and
lsum, from the tree that ported STABLEMTL_FLASH_POLY_EXP on), so swapping
the loaded library swaps the kernel under the same wrappers and launch
counters. A variant of one kernel is compared the same way: DIR is a copy
of this tree with that kernel's source patched, and --only names it.

1. Kernels, bf16, at the main paths' shapes: K1 at [35,4096,64] and
   [70,1024,64] and K2 at [7,4096,512] and [1,4096,512] (the batch-1
   inference step's), both softmax modes; K3 in exact softmax at
   [10,1728,64] (the training micro-step's) and at [70,1024,64] and
   [35,4096,64] (a 512x512 training step's), and K4 and K5 at the same
   three shapes on the exact forward's lse and delta = rowsum(dO o O); K6
   with erf gelu at the batch-2 serving step's four (R, C, F). Both
   versions are held against the plain version, then timed in the order
   other, this, this, other per round (CUDA events, 10 launches each)
   beside the plain version, the library call (SDPA; for K4 and K5 SDPA's
   flash backward alone, which computes dQ, dK and dV together; F.linear of
   K6's projection) and the bound.
2. Steps (unless --no-steps), each timed with the other tree's kernels and
   with this tree's in the same order, host clock around synchronized
   steps after a warm-up: a batch-1 inference step (full preset, bf16,
   fast math: phase 3's workload), a batch-2 serving step (the flagship
   config, bf16, exact softmax, STABLEMTL_FUSED_GEGLU=1: phase 5's) and a
   training micro-step (phase 4's flagship trainer settings, 288x384,
   micro-batch 2). The inference and serving steps' outputs with the
   other tree's kernels are held against those with this tree's.

Prints every reading, then one JSON line with all of them and the card's
name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

NAMES = ("flash_fwd_a", "flash_fwd_b", "flash_fwd_lse", "flash_bwd_dq",
         "flash_bwd_dkv", "geglu")
# (library, shape, modes): flash modes are the softmax's, K6's the gelu's
CASES = [("flash_fwd_a", (35, 4096, 64), ("fast", "exact")),
         ("flash_fwd_a", (70, 1024, 64), ("fast", "exact")),
         ("flash_fwd_b", (7, 4096, 512), ("fast", "exact")),
         ("flash_fwd_b", (1, 4096, 512), ("fast", "exact")),
         ("flash_fwd_lse", (10, 1728, 64), ("exact",)),
         ("flash_fwd_lse", (70, 1024, 64), ("exact",)),
         ("flash_fwd_lse", (35, 4096, 64), ("exact",)),
         ("flash_bwd_dq", (10, 1728, 64), ("exact",)),
         ("flash_bwd_dq", (70, 1024, 64), ("exact",)),
         ("flash_bwd_dq", (35, 4096, 64), ("exact",)),
         ("flash_bwd_dkv", (10, 1728, 64), ("exact",)),
         ("flash_bwd_dkv", (70, 1024, 64), ("exact",)),
         ("flash_bwd_dkv", (35, 4096, 64), ("exact",)),
         ("geglu", (57344, 320, 1280), ("erf",)),
         ("geglu", (14336, 640, 2560), ("erf",)),
         ("geglu", (3584, 1280, 5120), ("erf",)),
         ("geglu", (896, 1280, 5120), ("erf",))]


def build_other(parent: str, names) -> dict:
    """{name: ctypes library} of the other tree's kernel sources, each built
    as cuda_build builds this tree's (in its parts, where it has them)."""
    from pathlib import Path

    from stablemtl_tpu_torch.ops import cuda_build

    csrc = Path(parent) / "stablemtl_tpu_torch" / "csrc"
    out_dir = Path(cuda_build.BUILD_DIR) / "ab"  # git-ignored
    os.makedirs(out_dir, exist_ok=True)
    started = {name: (cuda_build.start_build(name, csrc,
                                             out_dir / f"lib{name}.so"),
                      out_dir / f"lib{name}.so") for name in names}
    libs = {}
    for name, (finish, out) in started.items():
        finish()
        libs[name] = ctypes.CDLL(str(out))
    return libs


def use(libs: dict):
    """Route the wrappers to `libs`."""
    from stablemtl_tpu_torch.ops import cuda_build

    cuda_build._loaded.update(libs)
    cuda_build._entry.cache_clear()


def case_calls(name, shape, mode, gen):
    """(kernel call, plain call, reference call, library call, bound,
    bound_by) on inputs made from `gen` for one case. The reference is what
    the kernel is held against: the plain version, or for K6 its arithmetic
    in f32 rounded once (as phase 2 holds it)."""
    import torch
    import torch.nn.functional as F

    import chip_smoke
    from stablemtl_tpu_torch.ops import flash_attention as fa
    from stablemtl_tpu_torch.ops import geglu

    if name == "geglu":
        x, w, b = chip_smoke.geglu_inputs(shape, torch.bfloat16, gen)
        tanh = mode == "tanh"
        return (lambda: geglu.geglu_fused(x, w, b, tanh),
                lambda: geglu.geglu_reference(x, w, b, tanh),
                lambda: chip_smoke.geglu_exact(x, w, b, tanh),
                lambda: F.linear(x, w, b),
                *chip_smoke.geglu_bound_ms(shape, torch.bfloat16))
    q, k, v = (torch.randn(shape, generator=gen, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    fast = mode == "fast"
    if name in ("flash_bwd_dq", "flash_bwd_dkv"):
        return backward_calls(name, shape, q, k, v, gen)
    if name == "flash_fwd_lse":
        # o and lse, as the training forward returns them
        work = dict(rows=1)
        kernel = lambda: fa.flash_fwd_resident_lse(q, k, v, fast)  # noqa
        plain = lambda: fa.flash_forward_lse_reference(q, k, v, fast)  # noqa
    else:
        work = {}
        wrapper = (fa.flash_fwd_resident if name == "flash_fwd_a"
                   else fa.flash_fwd_stream)
        kernel = lambda: wrapper(q, k, v, fast)  # noqa: E731
        plain = lambda: fa.flash_reference(q, k, v, fast)  # noqa: E731
    return (kernel, plain, plain,
            lambda: F.scaled_dot_product_attention(q[None], k[None],
                                                   v[None]),
            *chip_smoke.attention_bound_ms(*shape, torch.bfloat16, **work))


def backward_calls(name, shape, q, k, v, gen):
    """case_calls of K4 or K5 on the exact forward's lse and delta: the
    library call is SDPA's flash backward alone (chip_smoke.sdpa_backward)."""
    import torch

    import chip_smoke
    from stablemtl_tpu_torch.ops import flash_attention as fa

    do = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    o, lse = fa.flash_forward_lse_reference(q, k, v, False)
    args = (q, k, v, do, lse, fa.row_delta(do, o))
    if name == "flash_bwd_dq":
        wrapper, plain = fa.flash_bwd_dq, fa.flash_bwd_dq_reference
        work = dict(flops=6, tensors=5, rows=2)
    else:
        wrapper, plain = fa.flash_bwd_dkv, fa.flash_bwd_dkv_reference
        work = dict(flops=8, tensors=6, rows=2)
    return (lambda: wrapper(*args), lambda: plain(*args),
            lambda: plain(*args), chip_smoke.sdpa_backward(q, k, v, do),
            *chip_smoke.attention_bound_ms(*shape, torch.bfloat16, **work))


def kernel_ab(versions: dict, rounds: int) -> list:
    import torch

    import chip_smoke

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for name, shape, modes in CASES:
        if name not in versions["other"]:
            continue
        for mode in modes:
            kernel, plain, reference, library, bound, bound_by = case_calls(
                name, shape, mode, gen)
            ref = reference()
            row = dict(kernel=name, shape=list(shape), mode=mode)
            for tree, libs in versions.items():
                use(libs)
                got = kernel()
                # K3: (o, lse), K5: (dk, dv), each held on its own
                pairs = (zip(got, ref) if isinstance(ref, tuple)
                         else [(got, ref)])
                errs = [chip_smoke.compare(a, b) for a, b in pairs]
                row[f"{tree}_max_abs"] = [e[0] for e in errs]
                row[f"{tree}_rel_l2"] = [e[1] for e in errs]
            times = {tree: [] for tree in versions}
            for _ in range(rounds):
                for tree in ("other", "this", "this", "other"):
                    use(versions[tree])
                    times[tree].append(chip_smoke.cuda_time(kernel, 10))
            row["other_ms"], row["this_ms"] = times["other"], times["this"]
            row["plain_ms"] = chip_smoke.cuda_time(plain, 3)
            row["library_ms"] = chip_smoke.cuda_time(library, 10)
            row["bound_ms"], row["bound_by"] = bound, bound_by
            print(f"[ab] {json.dumps(row)}", flush=True)
            rows.append(row)
            del kernel, plain, reference, library, ref
            torch.cuda.empty_cache()
    use(versions["this"])
    return rows


def inference_workload(config, batch):
    """(step, steps per reading, True) of infer_all_tasks on `batch`
    serving requests: its outputs are compared across trees."""
    import torch

    import chip_smoke
    from stablemtl_tpu_torch.factory import build_pipeline
    from stablemtl_tpu_torch.predict import _to_norm

    pipe = build_pipeline(config, seed=0, image_hw=(512, 512))
    rgb = torch.stack([torch.from_numpy(_to_norm(im)).to(pipe.device)
                       for im in chip_smoke.serving_requests(batch,
                                                             seed=12)])
    return lambda: pipe.infer_all_tasks(rgb, None), 3, True


def train_workload():
    """(micro-step, steps per reading, False) of phase 4's training path:
    each micro-step moves the state on, so no output is compared."""
    import chip_smoke
    from stablemtl_tpu_torch.factory import build_pipeline
    from stablemtl_tpu_torch.train_state import (OptimizerConfig,
                                                 create_train_state,
                                                 make_train_step)

    pipe = build_pipeline(chip_smoke.full_config(
        "bfloat16", trainer=chip_smoke.TRAINER), seed=0,
        image_hw=chip_smoke.TRAIN_HW, trainable=True)
    cfg = OptimizerConfig(lr=1e-4, max_grad_norm=5.0, total_iters=25_000,
                          final_ratio=0.01, warmup_steps=100,
                          accumulation_steps=2)
    state = create_train_state(pipe.unet, cfg)
    step = make_train_step(pipe, base_seed=2024)
    batches = chip_smoke.train_batches(4, chip_smoke.TRAIN_BATCH, seed=5,
                                       device=pipe.device)
    cursor = [0]

    def micro_step():
        nonlocal state
        state, _ = step(state, batches[cursor[0] % len(batches)])
        cursor[0] += 1

    # 4 micro-steps a reading: 2 optimizer updates at accumulation 2
    return micro_step, 4, False


def step_ab(versions: dict, rounds: int) -> dict:
    import torch

    import chip_smoke

    def time_steps(run, n) -> float:
        run()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            run()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e3

    out = {}
    workloads = [
        ("infer_batch1", {"STABLEMTL_FAST_MATH": "1"},
         lambda: inference_workload(
             chip_smoke.full_config("bfloat16", fast_math=True), 1)),
        ("serve_batch2", {"STABLEMTL_FUSED_GEGLU": "1"},
         lambda: inference_workload(chip_smoke.FLAGSHIP_CONFIG, 2)),
        ("train_micro_step", {}, train_workload)]
    for label, env, workload in workloads:
        os.environ.update(env)
        try:
            run, n, compare = workload()
            outs, times = {}, {tree: [] for tree in versions}
            for _ in range(rounds):
                for tree in ("other", "this", "this", "other"):
                    use(versions[tree])
                    times[tree].append(time_steps(run, n))
                    if compare:
                        outs[tree] = run()
            out[label] = dict(other_ms=times["other"],
                              this_ms=times["this"], steps_per_reading=n)
            if compare:
                (out[label]["this_vs_other_max_abs"],
                 out[label]["this_vs_other_rel_l2"]) = chip_smoke.compare(
                    outs["this"], outs["other"])
            print(f"[ab] {label}: {json.dumps(out[label])}", flush=True)
            del run, outs
            torch.cuda.empty_cache()
        finally:
            for key in env:
                del os.environ[key]
    use(versions["this"])
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--parent", required=True,
                        help="root of the other tree")
    parser.add_argument("--rounds", type=int, default=1,
                        help="rounds of (other, this, this, other)")
    parser.add_argument("--no-steps", action="store_true",
                        help="time the kernels only")
    parser.add_argument("--only", action="append", choices=NAMES,
                        help="compare this library only (repeatable)")
    args = parser.parse_args()
    names = args.only or NAMES

    import torch

    from stablemtl_tpu_torch.ops import cuda_build

    if not torch.cuda.is_available():
        print("torch_flash_ab: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda_build.build()
    versions = {"this": {name: cuda_build.load(name) for name in names},
                "other": build_other(args.parent, names)}
    result = {"card": smi.stdout.strip(),
              "kernels": kernel_ab(versions, args.rounds)}
    if not args.no_steps:
        result["steps"] = step_ab(versions, args.rounds)
    for rows in (result["kernels"], result.get("steps", {}).values()):
        for row in rows:
            if isinstance(row, dict) and "this_ms" in row:
                row["this_median_ms"] = statistics.median(row["this_ms"])
                row["other_median_ms"] = statistics.median(row["other_ms"])
    print(json.dumps({"flash_ab": result}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
