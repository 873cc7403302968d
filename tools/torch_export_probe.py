#!/usr/bin/env python3
"""What the serving artifact of the PyTorch port costs, stage by stage.

    python3 tools/torch_export_probe.py [--preset full] [--res 512]
        [--batch 2] [--pair] [--device cuda] [--calls 20000]

Builds the multi-stream pipeline of `--preset` (seeded random weights; on
the card the flagship serving configuration's dtype, bf16, with
STABLEMTL_FUSED_GEGLU=1, as `chip_smoke.py` phase 8) and prints one JSON
line: the seconds of the `torch.export` trace, the graph's nodes before
and after `serving._drop_noop_casts`, the archive's bytes as
`torch.export.save` writes it and deflated (`export_pipeline`'s bytes),
the seconds of `load_exported`, and ms per step of the loaded program and
of eager `infer_all_tasks` (host clock, 3 steps after a warm-up, in
turns). With `--calls`, also the host microseconds per call of a no-op
op registered through `torch.library.custom_op` and through
`Library.define`/`impl` (the route `ops/cuda_build.define_op` takes),
beside the plain Python call, on CPU tensors. The CPU (`--device cpu`,
use the nano or tiny preset) gives host-side numbers only.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def op_call_us(calls: int) -> dict:
    """Host microseconds per call of one no-op op by each route."""
    import torch

    def plain(q, k, v, fast):
        return q.new_empty(q.shape)

    schema = "(Tensor q, Tensor k, Tensor v, bool fast) -> Tensor"
    custom = torch.library.custom_op("export_probe::custom", plain,
                                     mutates_args=(), schema=schema)
    lib = torch.library.Library("export_probe", "FRAGMENT")
    lib.define("low" + schema)
    lib.impl("low", plain, "CPU")
    routes = {"direct": plain, "custom_op": custom,
              "library": torch.ops.export_probe.low.default}
    q = torch.zeros(2, 4, 4)
    out = {}
    for _ in range(2):  # the second pass is kept: warm caches
        for name, fn in routes.items():
            t0 = time.perf_counter()
            for _ in range(calls):
                fn(q, q, q, False)
            out[name] = (time.perf_counter() - t0) / calls * 1e6
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--preset", default="full")
    parser.add_argument("--res", type=int, default=512)
    parser.add_argument("--batch", type=int, default=2)
    parser.add_argument("--pair", action="store_true")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--calls", type=int, default=0,
                        help="also time op dispatch over this many calls")
    args = parser.parse_args()

    import torch

    from stablemtl_tpu_torch.factory import build_pipeline
    from stablemtl_tpu_torch.serving import (_deflate, _drop_noop_casts,
                                             _Step, load_exported,
                                             params_bundle)

    on_card = args.device != "cpu"
    if on_card and not torch.cuda.is_available():
        print("torch_export_probe: no CUDA device", file=sys.stderr)
        return 2
    if on_card:
        os.environ["STABLEMTL_FUSED_GEGLU"] = "1"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    cfg = {"model": {"size_preset": args.preset,
                     "compute_dtype": "bfloat16" if on_card else "float32"},
           "trainer": {"multi_stream": True}}
    hw = (args.res, args.res)
    pipe = build_pipeline(cfg, seed=0, device=args.device, image_hw=hw)
    gen = torch.Generator(device=pipe.device).manual_seed(5)
    images = [torch.rand((args.batch, *hw, 3), generator=gen,
                         device=pipe.device) * 2 - 1
              for _ in range(1 + args.pair)]
    bundle = params_bundle(pipe)

    t0 = time.perf_counter()
    with torch.no_grad():
        program = torch.export.export(_Step(pipe), (bundle, *images),
                                      strict=False)
    trace_s = time.perf_counter() - t0
    program.example_inputs = None
    nodes_traced = len(program.graph.nodes)
    _drop_noop_casts(program.graph_module)
    buf = io.BytesIO()
    torch.export.save(program, buf)
    stored = buf.getvalue()
    blob = _deflate(stored)
    t0 = time.perf_counter()
    exported = load_exported(blob)
    load_s = time.perf_counter() - t0

    steps = {"artifact": lambda: exported.call(bundle, *images),
             "eager": lambda: pipe.infer_all_tasks(
                 images[0], images[1] if args.pair else None)}
    ms = {name: [] for name in steps}
    for name in ("artifact", "eager", "eager", "artifact"):
        steps[name]()
        sync()
        t0 = time.perf_counter()
        for _ in range(3):
            steps[name]()
        sync()
        ms[name].append((time.perf_counter() - t0) / 3 * 1e3)
    diff = (steps["artifact"]() - steps["eager"]()).abs().max().item()
    result = dict(device=(torch.cuda.get_device_name(0) if on_card
                          else "cpu"), preset=args.preset, res=args.res,
                  batch=args.batch, pair=args.pair, trace_s=trace_s,
                  nodes_traced=nodes_traced,
                  nodes_kept=len(program.graph.nodes),
                  bytes_stored=len(stored), bytes_deflated=len(blob),
                  load_s=load_s, ms_per_step=ms, max_abs_diff=diff)
    if args.calls:
        result["op_call_us"] = op_call_us(args.calls)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
