"""One run of one cell: `run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`.

The cell's traffic kind (bench_port/harness/kinds/) builds the program,
sets it up, measures for `--seconds`, and checks what the timed path
produced against the plain reference. This module checks the device,
reads the per-layer metrics from the traced run's record, looks for JAX
in the process, and prints the result: the numbers compared beside their
limits as the last lines of standard error, and one JSON object as the
last line of standard output."""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import subprocess
import sys
import time

from . import cells
from .check import verdict

FORBIDDEN = ("jax", "jaxlib", "flax", "stablemtl_tpu")


@dataclasses.dataclass
class Context:
    cell: cells.Cell
    seed: int
    seconds: float
    trace: bool
    t_start: float          # perf_counter at process start
    device: str = "cuda"

    def log(self, msg: str) -> None:
        print(f"[bench {self.cell.name}] {msg}", file=sys.stderr, flush=True)

    def setup_done(self) -> float:
        return time.perf_counter() - self.t_start


def forbidden_modules(names=None) -> list:
    """Loaded modules (or `names`) whose top-level name is JAX's, Flax's
    or the JAX package's, compared whole."""
    names = list(sys.modules) if names is None else names
    tops = {name.split(".", 1)[0] for name in names}
    return sorted(tops & set(FORBIDDEN))


def card_info() -> dict:
    """The card's name and power limit by nvidia-smi (empty when it
    cannot be read)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        return {}
    return {"nvidia_smi": out}


def parse(argv):
    ap = argparse.ArgumentParser(prog="bench_port/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def per_layer(cell: cells.Cell, record: dict) -> dict:
    out = {}
    for m in cell.per_layer:
        value = cells.reader(m["name"])(record)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def main(argv, t_start: float) -> int:
    args = parse(argv)
    cell = cells.find(args.workload)
    import torch

    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count < cell.chips:
        print(f"bench_port: {cell.name} needs {cell.chips} CUDA device(s); "
              f"{count} available", file=sys.stderr)
        return 2
    ctx = Context(cell=cell, seed=args.seed, seconds=args.seconds,
                  trace=bool(args.trace), t_start=t_start)
    from ..workcount import peaks
    ctx.log(f"card {card_info().get('nvidia_smi', 'not read')}; peaks: "
            f"bf16 {peaks.PEAK_BF16_FLOPS:.4g} FLOP/s, HBM "
            f"{peaks.PEAK_BYTES:.4g} B/s, exp2 {peaks.PEAK_EXP2:.4g}/s")
    res = cells.kind(cell.mix).run(ctx)
    found = forbidden_modules()
    if found:
        print(f"bench_port: the process loaded {', '.join(found)}",
              file=sys.stderr)
        return 3
    return report(ctx, res, torch.cuda.get_device_name(0))


def report(ctx: Context, res: dict, device_name: str) -> int:
    """Print the result; res: {"metrics", "record", "checks", "attempted",
    "failed", "memory_peak_bytes"} from the kind's run."""
    cell = ctx.cell
    if ctx.trace:
        metrics = per_layer(cell, res["record"])
    else:
        metrics = {m["name"]: {"value": float(res["metrics"][m["name"]]),
                               "unit": m["unit"]}
                   for m in cell.end_to_end}
    bad = [k for k, v in metrics.items() if not math.isfinite(v["value"])]
    if bad:
        print(f"bench_port: metrics not finite: {bad}", file=sys.stderr)
        return 4
    checks = res["checks"]
    correct = verdict(checks)
    device = {"platform": "gpu", "kind": device_name, "count": cell.chips,
              "memory_peak_bytes": int(res["memory_peak_bytes"])}
    line = {"correct": bool(correct), "attempted": int(res["attempted"]),
            "failed": int(res["failed"]), "metrics": metrics,
            "device": device}
    if ctx.trace:
        tr = res["record"]["trace"]
        device.update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        line["breakdown"] = {"device_ops": tr["device_ops"],
                             "idle_gaps": tr["idle_gaps"]}
    line["checks"] = {k: {"value": v if math.isfinite(v) else None,
                          "limit": lim} for k, (v, lim) in checks.items()}
    for k, (v, lim) in checks.items():
        print(f"check {k} {v!r} limit {lim!r}", file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return 0
