"""Offline all-task inference, closed loop: each step takes the next batch
of a host pool of distinct seeded images, runs the program's
`infer_all_tasks` and brings the [7, B, H, W, 3] maps back to host
memory; the next step starts when it has.

Mix parameters: batch, height, width, pool_batches (distinct batches in
the pool), warmup_steps, trace_steps (steps under the profiler in the
traced run).

Reported: images_per_s, the images of every step completed in the window
over the window, which ends when the first step that reaches `--seconds`
has brought its maps back. The output check compares one step of the
window, drawn from the seed, with the plain reference."""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import device as card
from .. import program
from ..refcheck import rel_l2_check, trace_record
from ..trace import timed


def run(ctx) -> dict:
    cfg, mix, dev = ctx.cell.config, ctx.cell.mix, ctx.device
    B, hw = int(mix["batch"]), (int(mix["height"]), int(mix["width"]))
    pipe = program.build_program(cfg, dev, hw)
    program.load_program(pipe, cfg, ctx.seed, dev)
    n_pool = int(mix["pool_batches"])
    pool = program.draw_images(ctx.seed, n_pool * B, hw, dev)
    batches = [np.ascontiguousarray(pool[i * B:(i + 1) * B])
               for i in range(n_pool)]

    def step(i: int) -> np.ndarray:
        x = torch.from_numpy(batches[i % n_pool]).to(dev)
        return pipe.infer_all_tasks(x, None).float().cpu().numpy()

    for i in range(int(mix["warmup_steps"])):
        step(i)
    card.synchronize(dev)
    setup_s = ctx.setup_done()
    ctx.log(f"set-up {setup_s:.3f} s")

    spans = {"decode": [], "unet": []}
    if ctx.trace:
        pipe.decode_latent = timed(pipe.decode_latent, spans["decode"])
        pipe.child_taps_all_tasks = timed(pipe.child_taps_all_tasks,
                                           spans["unet"])
        pipe.main_streams = timed(pipe.main_streams, spans["unet"])
    rng = program.host_rng(ctx.seed, "sample")
    setup_peak = card.peak_bytes(dev)
    card.reset_peak(dev)
    n, kept = 0, None
    t0 = time.perf_counter()
    while True:
        out = step(n)
        n += 1
        # one step of the window, uniformly at random (reservoir of one)
        if rng.random() < 1.0 / n:
            kept = (n - 1, out)
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    elapsed = time.perf_counter() - t0
    del out
    window_peak = card.peak_bytes(dev)
    images_per_s = n * B / elapsed
    ctx.log(f"window {elapsed:.3f} s, {n} steps, {images_per_s:.4f} "
            f"images/s")
    record = None
    if ctx.trace:
        for name in ("decode_latent", "child_taps_all_tasks", "main_streams"):
            delattr(pipe, name)
        from ...workcount.count import infer_work
        work = infer_work(cfg, B, hw)
        traced = int(mix["trace_steps"])
        record = trace_record(ctx, lambda: [step(i) for i in range(traced)],
                              elapsed * traced / n, traced_steps=traced,
                              kind="infer")
        record.update(
            images_per_s=images_per_s, flops_per_image=work["flops"] / B,
            attention_calls=work["attention"], batch=B, window_steps=n,
            window_peak_bytes=window_peak,
            span_ms={k: sum(s.elapsed_time(e) for s, e in v) / n
                     for k, v in spans.items()})
    memory_peak = max(setup_peak, card.peak_bytes(dev))
    del pipe
    idx, produced = kept
    gap = rel_l2_check(ctx, produced, batches[idx % n_pool])
    return {"metrics": {"images_per_s": images_per_s, "setup_s": setup_s},
            "record": record, "checks": {"worst_rel_l2": (
                gap, ctx.cell.limits["worst_rel_l2"])},
            "attempted": n * B, "failed": 0,
            "memory_peak_bytes": memory_peak}
