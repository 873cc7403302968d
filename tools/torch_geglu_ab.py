#!/usr/bin/env python3
"""The serving step of the PyTorch port with the fused GEGLU kernel (K6)
against the plain GEGLU, on one NVIDIA GPU.

    python3 tools/torch_geglu_ab.py [--rounds 4] [--steps 5]

Builds the flagship serving configuration (`chip_smoke.FLAGSHIP_CONFIG`:
bf16, exact softmax, erf gelu; seeded random weights) at 512x512 and times
`infer_all_tasks` on a batch of 2 requests (the step `ServingSession(batch=2)`
runs) with every feed-forward's GEGLU forced to K6 or to the plain version
(`geglu_proj(use_fused=True/False)`), in alternating pairs (K6, plain,
plain, K6, ...). Each round is one warm-up step and `--steps` timed steps
(host clock around synchronized steps). Prints each round, the medians, and
the card's name and power limit.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--rounds", type=int, default=4,
                        help="pairs of rounds (K6, plain / plain, K6)")
    parser.add_argument("--steps", type=int, default=5)
    args = parser.parse_args()

    import torch

    import chip_smoke
    from stablemtl_tpu_torch.factory import build_pipeline
    from stablemtl_tpu_torch.models import layers
    from stablemtl_tpu_torch.ops import cuda_build, geglu
    from stablemtl_tpu_torch.predict import _to_norm

    if not torch.cuda.is_available():
        print("torch_geglu_ab: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    cuda_build.build()
    res = chip_smoke.SERVE_RES
    pipe = build_pipeline(chip_smoke.FLAGSHIP_CONFIG, seed=0,
                          image_hw=(res, res))
    rgb = torch.stack([torch.from_numpy(_to_norm(im)).to(pipe.device)
                       for im in chip_smoke.serving_requests(2, seed=12)])
    plain_geglu = layers.geglu_proj

    def step_ms(fused: bool) -> float:
        layers.geglu_proj = functools.partial(geglu.geglu_proj,
                                              use_fused=fused)
        try:
            before = geglu.geglu_fused.launches
            pipe.infer_all_tasks(rgb, None)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(args.steps):
                pipe.infer_all_tasks(rgb, None)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) / args.steps * 1e3
            launched = geglu.geglu_fused.launches - before
        finally:
            layers.geglu_proj = plain_geglu
        if (launched > 0) != fused:
            raise RuntimeError(f"K6 launched {launched} times with "
                               f"use_fused={fused}")
        return ms

    times = {"K6": [], "plain": []}
    for r in range(args.rounds):
        order = ("K6", "plain") if r % 2 == 0 else ("plain", "K6")
        for mode in order:
            ms = step_ms(mode == "K6")
            times[mode].append(ms)
            print(f"[ab] round {r} {mode}: {ms:.2f} ms/step (batch 2, "
                  f"{args.steps} steps)", flush=True)
    summary = {mode: dict(median_ms=statistics.median(v), min_ms=min(v),
                          max_ms=max(v), rounds=v)
               for mode, v in times.items()}
    print(json.dumps({"serving_step_ab": summary, "card": smi.stdout.strip()}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
