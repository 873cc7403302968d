"""The program's own spans and counters (`stablemtl_tpu_torch.utils.
profiling`) over one run of a cell, on the card:

    python3 bench_port/trace_spans.py --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1>

The cell runs as `run.py` runs it, with the program's recorder on over
the window: from the end of set-up to the start of the traced stretch
(or, untraced, to the end of the run; the window's rate then holds the
recorder's cost). With --trace 1, one more stretch of the kind's traced
work runs before the kind's own two, under the profiler recording
device activity alone and under the recorder (`harness/spans.py::
device_stretch`): the idle time by program span comes from it.

Printed: run.py's result line; then one JSON line: the span metrics
(the readers `metrics/<name>.py` of SPAN_METRICS, on the run's record
with "spans", the window's `spans.summary`, and "idle_by_span", the
extra stretch's), the counters and the spans by name; with --trace 1
also the extra stretch's idle by span and its idle share, the program's
device spans beside the benchmark's own CUDA events (`agreement`) and a
marker span's stamps beside the profiler's record of it
(`clock_offsets_us`); for serving, the median request's queue wait,
step and copy beside its latency (`decomposition`), and the run's
latency_p50_ms and latency_p95_ms."""

import os
import sys
import time

T_START = time.perf_counter()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

SPAN_METRICS = (
    "encode_ms.infer", "banks_ms.infer", "queue_wait_p95_ms.serve",
    "fill.serve", "copy_ms.serve", "idle_copy.serve", "fwd_host_ms.train",
    "bwd_host_ms.train", "update_host_ms.train", "idle_fwd.train",
    "idle_bwd.train", "idle_update.train")
# the record's "kind" of each generator's runs
RECORD_KIND = {"offline": "infer", "serve": "serve", "train": "train"}


def _per(names, name, over):
    d = names.get(name)
    return None if d is None or d["device_ms"] is None else \
        d["device_ms"] / over


def agreement(record) -> dict:
    """The program's device spans a step or update beside the CUDA events
    the benchmark records around the same calls (`timed`): [spans,
    events] ms; None where a span has no device time."""
    names = record["spans"]["names"]
    if record["kind"] == "infer":
        steps = names["stablemtl.infer.encode"]["count"]
        child, main = (_per(names, f"stablemtl.infer.{n}", steps)
                       for n in ("child", "main"))
        return {
            "decode_ms": [_per(names, "stablemtl.infer.decode", steps),
                          record["span_ms"]["decode"]],
            "unet_ms": [None if main is None else (child or 0.0) + main,
                        record["span_ms"]["unet"]]}
    if record["kind"] == "train" and "stablemtl.train.apply" in names:
        updates = names["stablemtl.train.apply"]["count"]
        return {"update_ms": [_per(names, "stablemtl.train.apply", updates),
                              record["update_ms"]],
                "train.update_ms_an_update": _per(
                    names, "stablemtl.train.update", updates)}
    return {}


def decomposition(rec) -> dict:
    """The window's median request (nearest rank, as `latency_p50_ms`) by
    its span latency, submit to its group's last result: that latency
    and its queue wait, step and copy (host ms)."""
    from bench_port.harness.stats import percentile

    of = {name: {r: s for s in rec.spans if s.name == name
                 for r in (s.request if isinstance(s.request, tuple)
                           else (s.request,))}
          for name in ("stablemtl.serve.queue", "stablemtl.serve.step",
                       "stablemtl.serve.copy")}
    rows = sorted(
        ((of["stablemtl.serve.copy"][r].end_ns - q.start_ns) / 1e6,
         q.host_ms, of["stablemtl.serve.step"][r].host_ms,
         of["stablemtl.serve.copy"][r].host_ms)
        for r, q in of["stablemtl.serve.queue"].items()
        if r in of["stablemtl.serve.copy"])
    median = percentile([row[0] for row in rows], 50)
    latency, queue, step, copy = next(r for r in rows if r[0] == median)
    return {"requests": len(rows), "latency_ms": latency, "queue_ms": queue,
            "step_ms": step, "copy_ms": copy,
            "sum_ms": queue + step + copy}


def run_recorded(ctx) -> tuple:
    """(the kind's result, the span line) of one run of ctx's cell with
    the program's recorder on over the window and, traced, over the extra
    stretch."""
    import contextlib

    from bench_port.harness import cells, refcheck, spans
    from stablemtl_tpu_torch.utils import profiling

    window = contextlib.ExitStack()
    kept = {}
    setup_done = ctx.setup_done

    def window_starts() -> float:
        kept["window"] = window.enter_context(profiling.recording())
        return setup_done()

    kinds_profiled = refcheck.profiled

    def profiled(fn):
        window.close()
        kept["stretch"] = spans.device_stretch(fn)
        return kinds_profiled(fn)

    ctx.setup_done = window_starts
    refcheck.profiled = profiled
    try:
        res = cells.kind(ctx.cell.mix).run(ctx)
    finally:
        refcheck.profiled = kinds_profiled
        window.close()
    record = dict(res["record"]
                  or {"kind": RECORD_KIND[ctx.cell.mix["kind"]]})
    record["spans"] = spans.summary(kept["window"])
    out = {"span_metrics": {}, "counters": record["spans"]["counters"]}
    if "stretch" in kept:
        stretch = kept["stretch"]
        record["idle_by_span"] = stretch["idle_by_span"]
        out.update(idle_by_span=stretch["idle_by_span"],
                   stretch_idle_pct=100.0 * (1 - stretch["busy_s"]
                                             / stretch["window_s"]),
                   agreement=agreement(record),
                   clock_offsets_us=spans.clock_offsets_us())
    for name in SPAN_METRICS:
        value = cells.reader(name)(record)
        if value is not None:
            out["span_metrics"][name] = float(value)
    if record["kind"] == "serve":
        out["decomposition"] = decomposition(kept["window"])
        out.update({k: res["metrics"][k]
                    for k in ("latency_p50_ms", "latency_p95_ms")})
    out["names"] = record["spans"]["names"]
    return res, out


def main(argv=None) -> int:
    import argparse
    import json

    import torch

    from bench_port.harness import cells, main as harness

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    ctx = harness.Context(cell=cells.find(args.workload), seed=args.seed,
                          seconds=args.seconds, trace=bool(args.trace),
                          t_start=T_START)
    res, out = run_recorded(ctx)
    code = harness.report(ctx, res, torch.cuda.get_device_name(0))
    print(json.dumps(out), flush=True)
    return code


if __name__ == "__main__":
    # as run.py: the program's defaults, its caches inside the checkout
    for _name in [n for n in os.environ if n.startswith("STABLEMTL_")]:
        del os.environ[_name]
    _CACHE = os.path.join(ROOT, ".bench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(_CACHE,
                                                      "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(_CACHE, "triton")
    os.environ["USE_FLAX"] = "0"
    sys.exit(main())
