"""Batch assembly: samples -> fixed-shape training batches.

The step's contract (train_state.make_train_step) is a dict of NHWC arrays:
rgb_norm, rgb_next_norm, target_3ch [B,H,W,3] float32, valid_mask [B,H,W,1]
bool, task_idx scalar int32. GT->3ch packing happens HERE on the host
(pack_gt_to_3ch), so the step sees one shape for every task.

Prefetch: a small background thread pipelines host IO/augmentation with
device compute; `num_workers` > 0 builds batches in spawned worker
processes instead. Batches are numpy: the trainer moves them to the card.

Copy of `stablemtl_tpu/data/loader.py`, with `TASK_INDEX` and
`pack_gt_to_3ch` from the port's pipeline.
"""

from __future__ import annotations

import multiprocessing as mp
import queue
import threading
import traceback
from typing import Iterator, Optional, Sequence

import numpy as np

from ..pipeline import TASK_INDEX, pack_gt_to_3ch
from .base import OUTPUT_FIELD, OUTPUT_TYPE_FIELD, VALID_MASK_FIELD
from .sampler import MixedTaskSchedule


def collate_train_batch(samples: Sequence[dict]) -> dict:
    """Stack samples (same dataset => same shape) into the device batch."""
    task = samples[0][OUTPUT_TYPE_FIELD]
    rgb = np.stack([s["rgb_norm"] for s in samples]).astype(np.float32)
    rgb_next = np.stack([s["rgb_next_norm"] for s in samples]) \
        .astype(np.float32)
    gt = np.stack([s[OUTPUT_FIELD] for s in samples]).astype(np.float32)
    mask = np.stack([s[VALID_MASK_FIELD] for s in samples])
    if mask.ndim == 3:
        mask = mask[..., None]
    return {
        "rgb_norm": rgb,
        "rgb_next_norm": rgb_next,
        "target_3ch": pack_gt_to_3ch(gt, task),
        "valid_mask": mask.astype(bool),
        "task_idx": np.asarray(TASK_INDEX[task], np.int32),
    }


def _pool_worker(loader: "MixedTaskLoader", wid: int, n_workers: int,
                 start_step: int, max_steps: Optional[int], outq) -> None:
    """Worker-process entry (module level: spawn pickles it by name).

    Every worker replays the SAME deterministic schedule (it is
    (seed, step)-pure) and builds only the batches at global positions
    `pos % n_workers == wid` — so batch bytes are bit-identical to the
    single-process loader for any worker count, and there is no
    schedule-state channel between processes at all.

    The worker never touches CUDA: batch assembly is pure numpy, and the
    batches travel to the parent as numpy arrays."""
    try:
        loader.schedule.fast_forward(start_step)
        produced = 0
        while max_steps is None or produced < max_steps:
            step = loader.schedule.step
            try:
                ds_idx, indices = next(loader.schedule)
            except StopIteration:
                break
            if produced % n_workers == wid:
                outq.put(("ok", step,
                          loader._make_batch(step, ds_idx, indices)))
            produced += 1
        outq.put(("done", wid, None))
    except BaseException:  # noqa: BLE001 — relayed to the parent, not handled
        outq.put(("err", wid, traceback.format_exc()))


class MixedTaskLoader:
    """Iterates (step-aligned) training batches over the mixed datasets."""

    def __init__(self, datasets: Sequence, batch_size: int,
                 accumulation_steps: int = 1, seed: int = 0,
                 prob: Optional[Sequence[float]] = None,
                 iterative_sampling: bool = True,
                 prefetch: int = 2,
                 num_workers: int = 0,
                 shard: Optional[tuple] = None):
        """shard: optional (process_index, process_count) — multi-host data
        sharding. `batch_size` stays the GLOBAL per-micro-step batch; the
        schedule (task choice, dataset draw, sample indices, per-sample rng)
        is computed identically on every process (it is (seed, step)-pure),
        and each process materializes only its contiguous slice of each
        batch. Per-sample rng keys use the GLOBAL position j, so the
        sharded run is bit-identical to the single-host run.

        num_workers: 0 = in-process (plus the prefetch thread); N > 0 =
        N spawned worker PROCESSES build batches round-robin by step (the
        counterpart of the reference's 16 torch dataloader workers,
        train_base_config.yaml:60). Batches stay bit-identical and
        step-ordered for any worker count; composes with `shard` (each
        multi-host process runs its own local pool over its slice)."""
        self.datasets = list(datasets)
        self.schedule = MixedTaskSchedule(
            datasets, batch_size, accumulation_steps, seed=seed, prob=prob,
            iterative_sampling=iterative_sampling)
        self.seed = seed
        self.prefetch = prefetch
        self.num_workers = int(num_workers)
        if shard is not None:
            pi, pc = shard
            if not (0 <= pi < pc):
                raise ValueError(f"bad shard {shard}")
            if batch_size % pc != 0:
                raise ValueError(
                    f"global batch_size {batch_size} not divisible by "
                    f"process_count {pc}")
        self.shard = shard

    def __len__(self):
        return len(self.schedule)

    def _make_batch(self, step: int, ds_idx: int, indices) -> dict:
        ds = self.datasets[ds_idx]
        enum = list(enumerate(indices))
        if self.shard is not None:
            pi, pc = self.shard
            k = len(enum) // pc
            enum = enum[pi * k:(pi + 1) * k]
        samples = []
        for j, idx in enum:
            rng = np.random.default_rng(
                np.random.SeedSequence([self.seed, 15485863, step, j]))
            samples.append(ds.get(int(idx), rng))
        batch = collate_train_batch(samples)
        batch["step"] = step
        batch["dataset_idx"] = ds_idx
        return batch

    def _pool_batches(self, start_step: int,
                      max_steps: Optional[int]) -> Iterator[dict]:
        """num_workers > 0 path: spawn worker processes, reorder by step.

        The parent never computes a batch; it buffers out-of-order arrivals
        (bounded by the queue size) and yields in schedule order. Worker
        death without a message (OOM-kill, segfault) is detected by a
        liveness sweep on queue timeouts instead of hanging forever."""
        n = self.num_workers
        ctx = mp.get_context("spawn")
        outq = ctx.Queue(maxsize=2 * n + 2)
        procs = [ctx.Process(target=_pool_worker,
                             args=(self, wid, n, start_step, max_steps,
                                   outq),
                             daemon=True)
                 for wid in range(n)]
        for p in procs:
            p.start()
        try:
            pending: dict = {}
            next_step = start_step
            done = 0
            while done < n or pending:
                if next_step in pending:
                    yield pending.pop(next_step)
                    next_step += 1
                    continue
                try:
                    tag, a, b = outq.get(timeout=5.0)
                except queue.Empty:
                    dead = [p for p in procs
                            if not p.is_alive() and p.exitcode != 0]
                    if dead:
                        raise RuntimeError(
                            f"loader worker died with exit code "
                            f"{dead[0].exitcode} (no traceback — killed?)")
                    continue
                if tag == "err":
                    raise RuntimeError(f"loader worker {a} failed:\n{b}")
                if tag == "done":
                    done += 1
                    continue
                pending[a] = b
        finally:
            for p in procs:
                p.terminate()
            for p in procs:
                p.join(timeout=10)
            outq.close()

    def batches(self, start_step: int = 0,
                max_steps: Optional[int] = None) -> Iterator[dict]:
        """Yield batches from micro-step `start_step` (resume = pass the
        restored step counter; the schedule replays deterministically)."""
        if self.num_workers > 0:
            yield from self._pool_batches(start_step, max_steps)
            return
        self.schedule.fast_forward(start_step)
        produced = 0

        def gen():
            nonlocal produced
            while max_steps is None or produced < max_steps:
                step = self.schedule.step
                ds_idx, indices = next(self.schedule)
                yield self._make_batch(step, ds_idx, indices)
                produced += 1

        if self.prefetch <= 0:
            yield from gen()
            return

        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        _END = object()
        stop = threading.Event()

        def _put(item) -> bool:
            """put() that gives up when the consumer is gone — a plain
            blocking put would park this thread forever on a full queue
            after the caller abandons the generator (exit_after, an
            exception in the train step), leaking the thread AND leaving
            it to race a later batches() call on the shared schedule."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            # A worker failure must fail the TRAINING LOOP, not silently end
            # the epoch (else training "finishes" cleanly on a corrupt
            # sample): enqueue the exception and re-raise in the consumer.
            try:
                for b in gen():
                    if not _put(b):
                        return
                _put(_END)
            except BaseException as e:  # noqa: BLE001 — relayed, not handled
                _put(e)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is _END:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            # normal end, consumer break, or exception: stop the worker and
            # drain so a blocked put wakes, then join before the schedule
            # can be reused (fast_forward resets shared state)
            stop.set()
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
            t.join(timeout=10)
