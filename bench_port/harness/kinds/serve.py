"""Open-loop serving: single images arrive on a fixed schedule into the
program's `ServingSession`, whatever the state of earlier requests.

Mix parameters: batch and max_delay_s (the session's), height, width,
rate (requests/s offered), arrival_seed (the order of the gaps), pool
(distinct images), warmup_steps,
check_requests (results held to the reference), drain_s (how long past
the schedule results are waited for), trace_seconds (the traced stretch
of the same traffic in the traced run).

The schedule has N = rate x seconds requests. Its gaps are the N
quantiles (i + 1/2) / N of the exponential distribution of mean 1/rate,
in an order the mix's `arrival_seed` shuffles: Poisson-like arrivals, the
same for every run. The order sets the bursts that make the tail (seeds
that reordered the gaps moved p95 by 11-15 % between runs, where two
runs of one order moved it by 2-8 %: PERF.md), so the run's seed draws
the images, which image each request sends and the requests checked,
and not the arrivals.

Each request's latency runs from its scheduled send to its result on the
host; a request that fails or never completes counts as missing every
limit (an infinite latency)."""

from __future__ import annotations

import functools
import threading
import time

import numpy as np
import torch

from .. import device as card
from .. import program
from ..refcheck import reference, trace_record
from ..check import worst_rel_l2
from ..stats import percentile


def schedule(seed: int, rate: float, seconds: float) -> np.ndarray:
    """Send times (s from the window's start) of N = round(rate *
    seconds) requests, the first at 0."""
    n = max(1, int(round(rate * seconds)))
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n) / rate
    program.host_rng(seed, "arrivals").shuffle(gaps)
    return np.concatenate([[0.0], np.cumsum(gaps[:-1])])


class Sender:
    """Submits images at their scheduled times and records when each
    result reaches the host."""

    def __init__(self, session, pool, pick):
        self.session, self.pool, self.pick = session, pool, pick
        self.done_at = {}
        self.lateness = 0.0
        self._lock = threading.Lock()

    def _done(self, i, fut):
        t = time.perf_counter()
        with self._lock:
            self.done_at[i] = t

    def send(self, offsets, t0) -> list:
        futures = []
        for i, off in enumerate(offsets):
            delay = t0 + off - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
            self.lateness = max(self.lateness,
                                time.perf_counter() - (t0 + off))
            fut = self.session.submit(self.pool[self.pick[i]])
            fut.add_done_callback(functools.partial(self._done, i))
            futures.append(fut)
        return futures


def wait_all(futures, deadline: float) -> None:
    for fut in futures:
        try:
            fut.result(timeout=max(0.0, deadline - time.perf_counter()))
        except Exception:  # noqa: BLE001 - a failure is counted, not raised
            pass


def run(ctx) -> dict:
    from stablemtl_tpu_torch.serving import ServingSession

    cfg, mix, dev = ctx.cell.config, ctx.cell.mix, ctx.device
    hw = (int(mix["height"]), int(mix["width"]))
    pipe = program.build_program(cfg, dev, hw)
    program.load_program(pipe, cfg, ctx.seed, dev)
    pool = program.draw_images(ctx.seed, int(mix["pool"]), hw, dev)
    rate = float(mix["rate"])
    offsets = schedule(int(mix["arrival_seed"]), rate, ctx.seconds)
    n = len(offsets)
    pick = program.host_rng(ctx.seed, "images").integers(0, len(pool), n)
    sample = np.sort(program.host_rng(ctx.seed, "sample").choice(
        n, size=min(int(mix["check_requests"]), n), replace=False))
    session = ServingSession(pipe, batch=int(mix["batch"]),
                             max_delay_s=float(mix["max_delay_s"]))
    try:
        for _ in range(int(mix["warmup_steps"])):
            session.warmup(hw)
        card.synchronize(dev)
        setup_s = ctx.setup_done()
        ctx.log(f"set-up {setup_s:.3f} s; {n} requests at {rate} /s")
        setup_peak = card.peak_bytes(dev)
        card.reset_peak(dev)
        sender = Sender(session, pool, pick)
        t0 = time.perf_counter()
        futures = sender.send(offsets, t0)
        wait_all(futures, t0 + offsets[-1] + float(mix["drain_s"]))
        elapsed = time.perf_counter() - t0
        lat = np.full(n, np.inf)
        for i, fut in enumerate(futures):
            if fut.done() and not fut.cancelled() and \
                    fut.exception() is None and i in sender.done_at:
                lat[i] = sender.done_at[i] - (t0 + offsets[i])
        failed = int(np.isinf(lat).sum())
        kept = {int(i): futures[i].result() for i in sample
                if np.isfinite(lat[i])}
        del futures
        memory_peak = max(setup_peak, card.peak_bytes(dev))
        ctx.log(f"{n} requests in {elapsed:.3f} s, {failed} failed, the "
                f"sender at most {sender.lateness * 1e3:.3f} ms late")
        record = None
        if ctx.trace:
            part = offsets[offsets < float(mix["trace_seconds"])]
            tracer = Sender(session, pool, pick)

            def traced():
                t = time.perf_counter()
                wait_all(tracer.send(part, t),
                         t + part[-1] + float(mix["drain_s"]))
            record = trace_record(ctx, traced, kind="serve")
    finally:
        session.close()
    del session, pipe
    ref = reference(ctx)
    gaps = []
    for i in sample:
        if int(i) not in kept:
            gaps.append(float("nan"))
            continue
        x = torch.from_numpy(pool[pick[i]][None]).to(dev)
        want = ref.infer_all_tasks(x, None)[:, 0].cpu().numpy()
        gaps.append(worst_rel_l2(kept[int(i)], want))
    gap = max(gaps, key=lambda g: (not np.isfinite(g), g))
    ctx.log(f"worst relative L2 gap of {len(sample)} requests {gap!r}")
    return {"metrics": {"latency_p95_ms": percentile(lat, 95) * 1e3,
                        "latency_p50_ms": percentile(lat, 50) * 1e3,
                        "setup_s": setup_s},
            "record": record, "checks": {"worst_rel_l2": (
                gap, ctx.cell.limits["worst_rel_l2"])},
            "attempted": n, "failed": failed,
            "memory_peak_bytes": memory_peak}
