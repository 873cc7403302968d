"""The program's own spans and counters (`stablemtl_tpu_torch.utils.
profiling`) in a run: what a recording holds, summed by name (`summary`),
and the device's idle time put down to the program span that the thread
launching the device work was in (`idle_by_span`), over a stretch that
the profiler records device activity alone in (`device_stretch`).

The spans' stamps are `time.time_ns()`. A Chrome trace's event `ts` is
in us from the trace's `baseTimeNanoseconds` on the same clock (`to_ns`),
so a device event and a program span are compared with no host
operation recorded."""

from __future__ import annotations

import bisect
import collections
import json
import os
import tempfile
import threading
import time

import torch

from .trace import _device_ops, _merge, read_device

OUTSIDE = "outside program spans"
QUEUE = "stablemtl.serve.queue"
SERVE_STEP = "stablemtl.serve.step"


def to_ns(ts_us, base_ns: int) -> int:
    """A Chrome trace's time (us from its base) as `time.time_ns()`, in
    whole ns: a float of ~1.8e18 ns would keep only 256 ns steps."""
    return round(float(ts_us) * 1e3) + int(base_ns)


def summary(rec) -> dict:
    """{"names": {name: {"count", "host_ms", "device_ms"}}, "queue_ms":
    each request's wait in `serve.queue` in request order, "counters"}
    of a `profiling.Recording`; device_ms is None for a name without
    device events."""
    names = {}
    for s in rec.spans:
        d = names.setdefault(s.name, {"count": 0, "host_ms": 0.0,
                                      "device_ms": None})
        d["count"] += 1
        d["host_ms"] += s.host_ms
        if s.device_ms is not None:
            d["device_ms"] = (d["device_ms"] or 0.0) + s.device_ms
    queue = sorted((s for s in rec.spans if s.name == QUEUE),
                   key=lambda s: s.request)
    return {"names": names, "queue_ms": [s.host_ms for s in queue],
            "counters": dict(rec.counters)}


def launching_thread(spans) -> int:
    """The thread that launches the device work: serving's collector
    (the thread of `serve.step` spans) where there is one, else the main
    thread."""
    for s in spans:
        if s.name == SERVE_STEP:
            return s.thread
    return threading.main_thread().ident


def idle_by_span(xs, base_ns: int, window_ns, spans, thread: int) -> dict:
    """{span name: idle s} over the host-clock stretch window_ns (start,
    end) from complete trace events `xs` (device operations, times in us
    from base_ns): each gap with no device operation is put down to
    every name of the spans on `thread` open over its midpoint (a gap
    inside two nested spans counts in both), and to OUTSIDE where none
    is."""
    w0, w1 = window_ns
    busy = _merge((max(to_ns(e["ts"], base_ns), w0),
                   min(to_ns(float(e["ts"]) + float(e["dur"]), base_ns),
                       w1)) for e in _device_ops(xs))
    gaps, prev = [], w0
    for s, e in busy:
        if e <= s:
            continue
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if w1 > prev:
        gaps.append((prev, w1))
    by_name = collections.defaultdict(list)
    for s in spans:
        if s.thread == thread:
            by_name[s.name].append((s.start_ns, s.end_ns))
    opened = {n: _merge(v) for n, v in by_name.items()}
    starts = {n: [iv[0] for iv in v] for n, v in opened.items()}
    idle = collections.Counter()
    for s, e in gaps:
        mid, inside = (s + e) / 2, False
        for name, ivs in opened.items():
            i = bisect.bisect_right(starts[name], mid) - 1
            if i >= 0 and ivs[i][1] >= mid:
                idle[name] += (e - s) / 1e9
                inside = True
        if not inside:
            idle[OUTSIDE] += (e - s) / 1e9
    return dict(idle)


def _chrome_trace(prof) -> dict:
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)
    finally:
        os.remove(path)


def device_stretch(fn) -> dict:
    """Run fn() under the profiler recording device activity alone and
    under the program's recorder, and return `trace.read_device`'s record
    of it with "idle_by_span": {"window_s", "busy_s", "idle_s": {name:
    s}} (`idle_by_span` over the launching thread's spans) and "spans"
    (`summary` of the stretch)."""
    from torch.profiler import ProfilerActivity, profile

    from stablemtl_tpu_torch.utils import profiling

    torch.cuda.synchronize()
    with profiling.recording() as rec:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            w0 = time.time_ns()
            fn()
            torch.cuda.synchronize()
            w1 = time.time_ns()
    trace = _chrome_trace(prof)
    xs = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    record = read_device(xs, (w1 - w0) / 1e9)
    idle = idle_by_span(xs, int(trace["baseTimeNanoseconds"]), (w0, w1),
                        rec.spans, launching_thread(rec.spans))
    record.update(idle_by_span={"window_s": record["window_s"],
                                "busy_s": record["busy_s"], "idle_s": idle},
                  spans=summary(rec))
    return record


def clock_offsets_us(n: int = 20) -> list:
    """The distance (us) between a marker span's own stamps, start and
    end, and the profiler's record of it, with CUDA activity recorded
    and a product on the card inside each span."""
    from torch.profiler import ProfilerActivity, profile

    from stablemtl_tpu_torch.utils import profiling

    x = torch.randn(1024, 1024, device="cuda")
    with profiling.recording():  # first use: events, the profiler's hooks
        with profiling.span("bench.clock_marker", device=x.device):
            x @ x
    torch.cuda.synchronize()
    with profiling.recording() as rec:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for i in range(n):
                with profiling.span(f"bench.clock_marker.{i}",
                                    device=x.device):
                    x @ x
            torch.cuda.synchronize()
    trace = _chrome_trace(prof)
    base = int(trace["baseTimeNanoseconds"])
    marks = {e["name"]: e for e in trace["traceEvents"]
             if e.get("cat") == "user_annotation"}
    out = []
    for s in rec.spans:
        e = marks[s.name]
        start = to_ns(e["ts"], base)
        end = to_ns(float(e["ts"]) + float(e["dur"]), base)
        out += [(start - s.start_ns) / 1e3, (end - s.end_ns) / 1e3]
    return out
