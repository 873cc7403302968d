"""The training step at a fixed recipe, closed loop: micro-steps of the
program's `make_train_step` back to back, its optimizer updating at
every accumulation boundary.

Mix parameters: micro_batch, accumulation, height, width, pool (distinct
micro-batches, made on the card from the seed and kept in pinned host
memory), checked_updates (updates the reference follows), trace_steps
(micro-steps under the profiler in the traced run).

The task of micro-step i is (i // accumulation) % N_TASKS (the
reference module's, 7), as the partial-label loader shares one task over
an effective batch. Each micro-step copies its batch from pinned host
memory with non-blocking copies, as `trainer.py` does.

Set-up builds the pipeline, the train state and the step once, drives
them through the checked updates' micro-steps on distinct batches (the
window's own call and feed), recording each loss, the task masks the
banks drew, the first update's gradient norms (from Adam's first moment)
and, at the end, each parameter's change; the same objects then run the
window. Reported: train_images_per_s, the images of every micro-step
completed in the window over the window, which ends when the card has
finished the micro-step that reaches `--seconds`. After the window the
reference follows the checked micro-steps from the same seed."""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from .. import cells
from .. import device as card
from .. import program
from ..refcheck import reference, trace_record
from ..trace import StepLog, timed
from ...reference.train import B1, draws_of_masks, step_seed

STEP_KEYS = ("rgb_norm", "rgb_next_norm", "target_3ch", "valid_mask")


def make_batches(seed: int, mix: dict, dev) -> list:
    """`pool` micro-batches, pinned on the host: images in [-1, 1] and a
    valid mask whose top band of 0 to H/4 rows (a sky) is invalid. Each
    row's rgb, rgb_next and target have a brightness (mean in [-0.7,
    0.7]) and a contrast (0.2 to 0.6) of their own, as rows of real
    scenes differ: on rows of one noise the gradient of any half batch
    lies within 3 % of the whole batch's, under the program's own bf16
    gap (PERF.md), and a step that left rows out would pass."""
    B, H, W = int(mix["micro_batch"]), int(mix["height"]), int(mix["width"])
    gen = program.generator(seed, "batches", dev)
    out = []
    for _ in range(int(mix["pool"])):
        imgs = torch.rand((3, B, H, W, 3), generator=gen, device=dev) * 2 - 1
        mean = torch.rand((3, B, 1, 1, 1), generator=gen, device=dev)
        contrast = torch.rand((3, B, 1, 1, 1), generator=gen, device=dev)
        imgs = (mean * 1.4 - 0.7 + (0.2 + 0.4 * contrast) * imgs).clamp(-1, 1)
        band = torch.randint(0, H // 4 + 1, (B, 1, 1, 1), generator=gen,
                             device=dev)
        rows = torch.arange(H, device=dev)[None, :, None, None]
        valid = (rows >= band).expand(B, H, W, 1)
        b = {"rgb_norm": imgs[0], "rgb_next_norm": imgs[1],
             "target_3ch": imgs[2], "valid_mask": valid}
        out.append({k: v.cpu().pin_memory() if card.on_cuda(dev)
                    else v.cpu() for k, v in b.items()})
    return out


def task_of(i: int, accumulation: int, n_tasks: int) -> int:
    return (i // accumulation) % n_tasks


def optimizer_config(cfg: dict, accumulation: int):
    from stablemtl_tpu_torch.factory import build_optimizer_config

    return build_optimizer_config(cfg["program_config"], accumulation)


def reference_optimizer(oc) -> dict:
    """The optimizer the reference runs, from the configuration's values
    as the program's factory reads them."""
    return {"lr": oc.lr, "total": oc.total_iters,
            "final_ratio": oc.final_ratio, "warmup": oc.warmup_steps,
            "accumulation": oc.accumulation_steps, "clip": oc.max_grad_norm,
            "schedule": oc.use_schedule}


def change_norms(params: dict, cfg: dict, seed: int, dev) -> dict:
    """Per parameter name, the norm of its change from the seed's
    weights."""
    w0 = program.draw_weights(cfg, seed, dev,
                              program.weight_dtypes(cfg, True))["unet"]
    return {n: float((p.detach() - w0[n]).norm()) for n, p in params.items()}


def leaf_gap(prog, ref) -> float:
    """The worst leaf's |program norm - reference norm| over the larger of
    the reference leaf's norm and the median leaf's."""
    p, r = np.asarray(prog, np.float64), np.asarray(ref, np.float64)
    med = float(np.median(r))
    return float((np.abs(p - r) / np.maximum(r, med)).max())


@dataclasses.dataclass
class Readings:
    """What one side gives of the checked micro-steps: each loss, the
    first update's gradient as the optimizer gets it (on the host) and
    each parameter's change after the last update (per parameter name),
    and the task masks' draws."""
    losses: list
    first_grad: dict
    changes: dict
    draws: list


@dataclasses.dataclass
class Program:
    """The program's training objects, built once and handed from set-up
    to the window."""
    pipe: object
    state: object
    step: object
    oc: object
    base_seed: int
    pool: list
    accumulation: int
    n_tasks: int

    def feed(self, i: int) -> dict:
        dev = self.pipe.device
        b = {key: self.pool[i % len(self.pool)][key].to(dev, non_blocking=True)
             for key in STEP_KEYS}
        b["task_idx"] = task_of(i, self.accumulation, self.n_tasks)
        return b


def build(ctx) -> Program:
    from stablemtl_tpu_torch.train_state import (create_train_state,
                                                 make_train_step)

    cfg, mix, dev = ctx.cell.config, ctx.cell.mix, ctx.device
    k = int(mix["accumulation"])
    hw = (int(mix["height"]), int(mix["width"]))
    pipe = program.build_program(cfg, dev, hw, trainable=True)
    program.load_program(pipe, cfg, ctx.seed, dev, trainable=True)
    oc = optimizer_config(cfg, k)
    base_seed = program.derived_seed(ctx.seed, "steps")
    return Program(pipe=pipe, state=create_train_state(pipe.unet, oc),
                   step=make_train_step(pipe, base_seed=base_seed), oc=oc,
                   base_seed=base_seed, pool=make_batches(ctx.seed, mix, dev),
                   accumulation=k, n_tasks=cells.reference_of(cfg).N_TASKS)


def checked_steps(ctx, prog: Program) -> Readings:
    """Drive the program through the checked micro-steps, recording what
    the reference is held to."""
    from stablemtl_tpu_torch.models.transformer import TaskAttentionBank

    banks = [m for m in prog.pipe.unet.modules()
             if isinstance(m, TaskAttentionBank)]
    drawn = []

    def recording(bank):
        real = bank._mask_bias

        def wrapper(*a, **kw):
            m = real(*a, **kw)
            if m is not None:
                drawn[-1].append(m.detach().clone())
            return m
        return wrapper

    for bank in banks:
        bank._mask_bias = recording(bank)
    losses, first_grad = [], {}
    try:
        for i in range(n_checked(ctx)):
            drawn.append([])
            prog.state, metrics = prog.step(prog.state, prog.feed(i))
            losses.append(float(metrics["loss"]))
            if i == prog.accumulation - 1:
                # the first update's gradient, as Adam's first moment
                # holds it after one update
                first_grad = {n: (m / (1 - B1)).cpu() for n, m in
                              zip(prog.state.params, prog.state.opt.mu)}
    finally:
        for bank in banks:
            del bank._mask_bias
    changes = change_norms(prog.state.params, ctx.cell.config, ctx.seed,
                           ctx.device)
    return Readings(losses=losses, first_grad=first_grad, changes=changes,
                    draws=[draws_of_masks(d) for d in drawn])


def n_checked(ctx) -> int:
    mix = ctx.cell.mix
    return int(mix["accumulation"]) * int(mix["checked_updates"])


def run(ctx) -> dict:
    cfg, mix, dev = ctx.cell.config, ctx.cell.mix, ctx.device
    B, hw = int(mix["micro_batch"]), (int(mix["height"]), int(mix["width"]))
    prog = build(ctx)
    readings = checked_steps(ctx, prog)
    card.synchronize(dev)
    setup_s = ctx.setup_done()
    ctx.log(f"set-up {setup_s:.3f} s; losses {readings.losses}")

    spans = []
    if ctx.trace:
        prog.state.opt._apply = timed(prog.state.opt._apply, spans)
    setup_peak = card.peak_bytes(dev)
    card.reset_peak(dev)
    i = first = n_checked(ctx)
    t0 = time.perf_counter()
    with StepLog(card.on_cuda(dev)) as steps:
        while True:
            prog.state, metrics = prog.step(prog.state, prog.feed(i))
            i += 1
            steps.mark()
            if time.perf_counter() - t0 >= ctx.seconds:
                break
        card.synchronize(dev)
    elapsed = time.perf_counter() - t0
    done = i - first
    rate = done * B / elapsed
    window_peak = card.peak_bytes(dev)
    ctx.log(f"window {elapsed:.3f} s, {done} micro-steps, {rate:.4f} "
            f"images/s, loss {float(metrics['loss'])!r}")
    ctx.log(steps.summary())
    record = None
    if ctx.trace:
        del prog.state.opt._apply
        from ...workcount.count import train_work
        work = train_work(cfg, B, hw)
        traced = int(mix["trace_steps"])

        def traced_steps():
            nonlocal i
            for _ in range(traced):
                prog.state, _ = prog.step(prog.state, prog.feed(i))
                i += 1
        record = trace_record(ctx, traced_steps, elapsed * traced / done,
                              kind="train", traced_steps=traced)
        record.update(
            images_per_s=rate, flops_per_image=work["flops"] / B,
            attention_calls=work["attention"], window_peak_bytes=window_peak,
            update_ms=(sum(s.elapsed_time(e) for s, e in spans)
                       / max(1, len(spans))))
    memory_peak = max(setup_peak, card.peak_bytes(dev))
    pool, base_seed, oc = prog.pool, prog.base_seed, prog.oc
    del prog, metrics
    checks = compare(ctx, readings, reference_readings(
        ctx, pool, base_seed, oc, follow=readings.draws))
    return {"metrics": {"train_images_per_s": rate, "setup_s": setup_s},
            "record": record, "checks": checks, "attempted": done * B,
            "failed": 0, "memory_peak_bytes": memory_peak}


def reference_readings(ctx, pool, base_seed, oc, follow=None,
                       rows=None) -> tuple:
    """(Readings, trainer) of the reference through the checked
    micro-steps in the current `precision`, following the draws `follow`
    at near ties; rows: a slice of each batch's rows (a fault: the mean
    over half the batch)."""
    dev, k = ctx.device, oc.accumulation_steps
    plain = cells.reference_of(ctx.cell.config)
    trainer = plain.Trainer(reference(ctx, trainable=True),
                            reference_optimizer(oc))
    start = [p.detach().clone() for p in trainer.params]
    losses, draws = [], []
    for i in range(n_checked(ctx)):
        batch = {key: pool[i % len(pool)][key].to(dev) for key in STEP_KEYS}
        if rows is not None:
            batch = {key: v[rows] for key, v in batch.items()}
        gen = torch.Generator(device=dev).manual_seed(
            step_seed(base_seed, i))
        task = task_of(i, k, plain.N_TASKS)
        losses.append(trainer.micro_step(batch, task, gen,
                                         None if follow is None
                                         else follow[i]))
        draws.append(draws_of_masks(trainer.last_masks))
    names = trainer.names
    readings = Readings(
        losses=losses, first_grad=dict(zip(names, trainer.first_grad)),
        changes={n: float((p.detach() - s).norm())
                 for n, p, s in zip(names, trainer.params, start)},
        draws=draws)
    return readings, trainer


def compare(ctx, prog: Readings, ref_and_trainer) -> dict:
    """The numbers compared with their limits: the worst micro-step's
    relative loss gap; over the leaves whose reference gradient exceeds a
    thousandth of the median leaf's (the others move by round-off alone),
    the worst leaf's gap between the two sides' norms of the first
    update's gradient and of the change after the last update, and
    ||g_prog - g_ref|| over ||g_ref|| of the first update's gradient, all
    those leaves together (a gradient of other rows has nearly the same
    norms); and the task-mask draws that differ beyond a near tie."""
    ref, trainer = ref_and_trainer
    names = trainer.names
    norms = {n: float(ref.first_grad[n].norm()) for n in names}
    med = float(np.median(list(norms.values())))
    kept = [n for n in names if norms[n] >= 1e-3 * med]

    def gap(a, b):
        return leaf_gap([a[n] for n in kept], [b[n] for n in kept])

    prog_norms = {n: float(prog.first_grad[n].norm()) for n in kept}
    diff = sum(float((prog.first_grad[n] - ref.first_grad[n]).norm()) ** 2
               for n in kept)
    lim = ctx.cell.limits
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(prog.losses,
                                                       ref.losses))
    checks = {
        "loss_gap": (loss_gap, lim["loss_gap"]),
        "grad_gap": (gap(prog_norms, norms), lim["grad_gap"]),
        "grad_dir_gap": ((diff / sum(norms[n] ** 2 for n in kept)) ** 0.5,
                         lim["grad_dir_gap"]),
        "change_gap": (gap(prog.changes, ref.changes), lim["change_gap"]),
        "mask_mismatches": (float(trainer.mismatches),
                            lim["mask_mismatches"]),
    }
    ctx.log(f"reference losses {ref.losses}; near ties followed "
            f"{trainer.ties}; leaves compared {len(kept)} of {len(names)}")
    return checks
