#!/usr/bin/env python3
"""The flash forward kernels of this tree (K1, kernel A; K2, kernel B)
against another tree's sources of them, on one NVIDIA GPU.

    python3 tools/torch_flash_ab.py --parent DIR [--rounds 1] [--no-steps]

DIR is the root of another checkout (for example a `git archive` of the
parent commit unpacked into a git-ignored directory). Its
`stablemtl_tpu_torch/csrc/flash_fwd_a.cu` and `flash_fwd_b.cu` are built
with this tree's nvcc flags into DIR/_ab_build and loaded with ctypes beside
this tree's libraries. Both trees' entry points share one C signature, so
swapping the loaded library swaps the kernel under the same wrappers and
launch counters.

1. Kernels, bf16, fast and exact softmax, at K1's [35,4096,64] and
   [70,1024,64] and K2's [7,4096,512] and [1,4096,512] (the batch-1 main
   path's shapes): both versions held against the plain version, then
   timed in the order other, this, this, other per round (CUDA events, 10
   launches each) beside the plain version, SDPA and the bound.
2. Steps (unless --no-steps), each timed with the other tree's kernels and
   with this tree's in the same order, host clock around 3 synchronized
   steps after a warm-up: a batch-1 inference step (full preset, bf16,
   fast math: phase 3's workload) and a batch-2 serving step (the flagship
   config, bf16, exact softmax, STABLEMTL_FUSED_GEGLU=1: phase 5's).

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

NAMES = ("flash_fwd_a", "flash_fwd_b")
SHAPES = {"flash_fwd_a": [(35, 4096, 64), (70, 1024, 64)],
          "flash_fwd_b": [(7, 4096, 512), (1, 4096, 512)]}


def build_other(parent: str) -> dict:
    """{name: ctypes library} of the other tree's kernel sources."""
    from stablemtl_tpu_torch.ops import cuda_build

    csrc = os.path.join(parent, "stablemtl_tpu_torch", "csrc")
    out_dir = os.path.join(parent, "_ab_build")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name in NAMES:
        out = os.path.join(out_dir, f"lib{name}.so")
        cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", out,
               os.path.join(csrc, f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       out)
    libs = {}
    for name, (proc, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the other {name}:\n{log}")
        libs[name] = ctypes.CDLL(out)
    return libs


def use(libs: dict):
    """Route the wrappers to `libs`."""
    from stablemtl_tpu_torch.ops import cuda_build

    cuda_build._loaded.update(libs)
    cuda_build._entry.cache_clear()


def kernel_ab(versions: dict, rounds: int) -> list:
    import torch
    import torch.nn.functional as F

    import chip_smoke
    from stablemtl_tpu_torch.ops import flash_attention as fa

    wrapper = {"flash_fwd_a": fa.flash_fwd_resident,
               "flash_fwd_b": fa.flash_fwd_stream}
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for name in NAMES:
        kernel = wrapper[name]
        for shape in SHAPES[name]:
            q, k, v = (torch.randn(shape, generator=gen, device="cuda")
                       .to(torch.bfloat16) for _ in range(3))
            for fast in (True, False):
                ref = fa.flash_reference(q, k, v, fast_softmax=fast)
                row = dict(kernel=name, shape=list(shape),
                           softmax="fast" if fast else "exact")
                for tree, libs in versions.items():
                    use(libs)
                    row[f"{tree}_max_abs"], row[f"{tree}_rel_l2"] = \
                        chip_smoke.compare(kernel(q, k, v, fast), ref)
                times = {tree: [] for tree in versions}
                for _ in range(rounds):
                    for tree in ("other", "this", "this", "other"):
                        use(versions[tree])
                        times[tree].append(chip_smoke.cuda_time(
                            lambda: kernel(q, k, v, fast), 10))
                row["other_ms"], row["this_ms"] = times["other"], \
                    times["this"]
                row["plain_ms"] = chip_smoke.cuda_time(
                    lambda: fa.flash_reference(q, k, v, fast), 3)
                row["sdpa_ms"] = chip_smoke.cuda_time(
                    lambda: F.scaled_dot_product_attention(
                        q[None], k[None], v[None]), 10)
                row["bound_ms"], row["bound_by"] = \
                    chip_smoke.attention_bound_ms(*shape, q.dtype)
                print(f"[ab] {json.dumps(row)}", flush=True)
                rows.append(row)
            del q, k, v
            torch.cuda.empty_cache()
    use(versions["this"])
    return rows


def step_ab(versions: dict, rounds: int) -> dict:
    import torch

    import chip_smoke
    from stablemtl_tpu_torch.factory import build_pipeline
    from stablemtl_tpu_torch.predict import _to_norm

    def time_steps(run, n=3) -> float:
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
         lambda: chip_smoke.full_config("bfloat16", fast_math=True), 1),
        ("serve_batch2", {"STABLEMTL_FUSED_GEGLU": "1"},
         lambda: chip_smoke.FLAGSHIP_CONFIG, 2)]
    for label, env, config, batch in workloads:
        os.environ.update(env)
        try:
            pipe = build_pipeline(config(), seed=0, image_hw=(512, 512))
            rgb = torch.stack([
                torch.from_numpy(_to_norm(im)).to(pipe.device)
                for im in chip_smoke.serving_requests(batch, seed=12)])
            outs, times = {}, {tree: [] for tree in versions}
            for _ in range(rounds):
                for tree in ("other", "this", "this", "other"):
                    use(versions[tree])
                    times[tree].append(time_steps(
                        lambda: pipe.infer_all_tasks(rgb, None)))
                    outs[tree] = pipe.infer_all_tasks(rgb, None)
            max_abs, rel = chip_smoke.compare(outs["this"], outs["other"])
            out[label] = dict(other_ms=times["other"],
                              this_ms=times["this"],
                              this_vs_other_max_abs=max_abs,
                              this_vs_other_rel_l2=rel)
            print(f"[ab] {label}: {json.dumps(out[label])}", flush=True)
            del pipe, outs
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
    args = parser.parse_args()

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
    versions = {"this": {name: cuda_build.load(name) for name in NAMES},
                "other": build_other(args.parent)}
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
