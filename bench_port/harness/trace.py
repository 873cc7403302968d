"""The traced run's device record: `torch.profiler` over a bounded stretch
of steady work, run twice; each Chrome trace is written under TMPDIR,
read, and deleted.

The first stretch records device activity alone, whose cost to the host
is CUPTI's: from it come the device intervals (kernels, copies,
memsets), their union (busy time), device time by kernel name, and the
window, the host clock's time of the stretch. The second records host
operations too, which slows a host-bound step by half or more; it serves
only to name what the host was doing in each idle gap (the innermost
host operation of any host thread over the middle of the gap), and its
window is kept beside the first's so that slowing shows."""

from __future__ import annotations

import bisect
import collections
import gc
import json
import os
import tempfile
import time

import numpy as np
import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "bench.traced_window"
TOP = 10
NAME_CHARS = 120  # of a kernel's or host operation's name in `breakdown`


def timed(fn, spans: list):
    """fn, with CUDA events recorded around each call, appended to
    `spans` as (start, end)."""
    def wrapper(*a, **kw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*a, **kw)
        end.record()
        spans.append((start, end))
        return out
    return wrapper


class StepLog:
    """Over a window: each step's end on the host's clock and, on a card,
    on the device's (a CUDA event; no synchronisation), and the garbage
    collector's pauses: what spreads a rate from run to run. `mark()`
    after each step."""

    def __init__(self, on_card: bool):
        self.on_card = on_card
        self.host, self.events = [], []
        self.gc_s, self.gc_full = 0.0, 0
        self._gc_t0 = 0.0

    def _gc(self, phase, info):
        if phase == "start":
            self._gc_t0 = time.perf_counter()
        else:
            self.gc_s += time.perf_counter() - self._gc_t0
            self.gc_full += info["generation"] == 2

    def __enter__(self):
        gc.callbacks.append(self._gc)
        self.mark()
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self._gc)

    def mark(self) -> None:
        self.host.append(time.perf_counter())
        if self.on_card:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            self.events.append(e)

    def summary(self) -> str:
        """One line, once the device has finished the window's work."""
        def quart(ms):
            q = np.percentile(ms, [0, 25, 50, 75, 100])
            half = max(1, len(ms) // 2)
            return (f"min {q[0]:.1f} q1 {q[1]:.1f} median {q[2]:.1f} q3 "
                    f"{q[3]:.1f} max {q[4]:.1f}; halves' medians "
                    f"{np.median(ms[:half]):.1f}, "
                    f"{np.median(ms[-half:]):.1f}")
        out = [f"step ms, host clock: {quart(np.diff(self.host) * 1e3)}"]
        if self.events:
            out.append("device clock: " + quart(np.array([
                a.elapsed_time(b) for a, b in zip(self.events,
                                                   self.events[1:])])))
        out.append(f"gc {self.gc_s * 1e3:.1f} ms ({self.gc_full} full)")
        return "; ".join(out)


def _events(prof) -> list:
    """The complete ("X") events of a finished profiler's Chrome trace."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return [e for e in events if e.get("ph") == "X"]


def profiled(fn):
    """Run fn() under the profiler twice, device activity alone and then
    with the host's, and return the record: `read_device` of the first,
    with `idle_gaps` (`read_idle_gaps`) and `host_traced_window_s` of the
    second."""
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    record = read_device(_events(prof), window_s)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        with record_function(WINDOW):
            fn()
            torch.cuda.synchronize()
        record["host_traced_window_s"] = time.perf_counter() - t0
    record["idle_gaps"] = read_idle_gaps(_events(prof))
    return record


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _innermost(host, starts, t: float) -> str:
    """The name of the host operation with the latest start among those
    that run over time t (the innermost, where they nest)."""
    i = bisect.bisect_right(starts, t) - 1
    for h in host[max(0, i - 4000):i + 1][::-1]:
        if float(h["ts"]) + float(h["dur"]) >= t:
            return h["name"]
    return "host between operations"


def _device_ops(xs) -> list:
    dev = [e for e in xs if e.get("cat") in DEVICE_CATS]
    if not dev:
        raise RuntimeError("the trace holds no device operation: the "
                           "profiler saw no kernel")
    return dev


def read_device(xs, window_s: float) -> dict:
    """{"busy_s", "window_s", "kernels": {name: s}, "n_kernels",
    "device_ops": top names by time} of complete trace events (times in
    us) that hold a synchronised stretch's device operations, which took
    window_s on the host's clock."""
    dev = _device_ops(xs)
    busy_s = sum(e - s for s, e in _merge(
        (float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in dev)) / 1e6
    by_name = collections.Counter()
    n_kernels = 0
    for e in dev:
        by_name[e["name"]] += float(e["dur"]) / 1e6
        n_kernels += e.get("cat") == "kernel"
    return {
        "busy_s": busy_s, "window_s": window_s,
        "kernels": dict(by_name), "n_kernels": n_kernels,
        "device_ops": [[n[:NAME_CHARS], s]
                       for n, s in by_name.most_common(TOP)],
    }


def read_idle_gaps(xs) -> list:
    """The host activities that most idle device time fell in, [[name,
    s]], over the host range named WINDOW, from complete trace events of
    host and device (times in us)."""
    win = [e for e in xs if e.get("name") == WINDOW
           and e.get("cat") == "user_annotation"]
    if not win:
        raise RuntimeError("the trace holds no traced window")
    w0 = float(win[0]["ts"])
    dev = _device_ops(xs)
    w1 = max(float(win[0]["ts"]) + float(win[0]["dur"]),
             max(float(e["ts"]) + float(e["dur"]) for e in dev))
    busy = _merge((max(float(e["ts"]), w0), min(float(e["ts"]) +
                                                 float(e["dur"]), w1))
                  for e in dev)
    gaps, prev = [], w0
    for s, e in busy:
        if e <= s:
            continue
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if w1 > prev:
        gaps.append((prev, w1))
    host = sorted((e for e in xs if e.get("cat") in ("cpu_op",
                                                      "user_annotation")
                   and e.get("name") != WINDOW),
                  key=lambda h: float(h["ts"]))
    starts = [float(h["ts"]) for h in host]
    idle = collections.Counter()
    for s, e in gaps:
        idle[_innermost(host, starts, (s + e) / 2)] += (e - s) / 1e6
    return [[n[:NAME_CHARS], s] for n, s in idle.most_common(TOP)]
