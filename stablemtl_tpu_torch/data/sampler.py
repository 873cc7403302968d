"""Deterministic mixed-task batch schedule.

Rebuild of reference src/dataset/mixed_sampler.py:84-115 as a replayable
schedule: the reference wraps torch samplers around a stateful generator;
here every draw derives from (seed, counters) so resume = fast-forwarding
`step` cheap RNG draws — no dataloader state to checkpoint (SURVEY.md §7).

Semantics preserved:
- iterative_sampling=True: task = effective_batch_idx % n_tasks, so all
  `accumulation_steps` micro-batches of an effective batch share one task
  (mixed_sampler.py:91-97).
- dataset within the task chosen by normalized probability (multinomial,
  :98-103) PER MICRO-BATCH — one effective batch mixes the shared task's
  datasets; default prob proportional to the dataset's batch count.
- per-dataset sample order: a fresh permutation per pass (shuffle), batches
  drawn with drop_last (:40-66).

Copy of `stablemtl_tpu/data/sampler.py`: the port keeps its
own so that it imports nothing of the JAX package.
"""

from __future__ import annotations

from collections import defaultdict
from typing import List, Optional, Sequence, Tuple

import numpy as np


class MixedTaskSchedule:
    """Yields (dataset_index, sample_indices) per micro-batch."""

    def __init__(self, datasets: Sequence, batch_size: int,
                 accumulation_steps: int = 1, seed: int = 0,
                 prob: Optional[Sequence[float]] = None,
                 iterative_sampling: bool = True, shuffle: bool = True,
                 drop_last: bool = True):
        self.datasets = list(datasets)
        self.batch_size = batch_size
        self.accumulation_steps = accumulation_steps
        self.seed = seed
        self.iterative_sampling = iterative_sampling
        self.shuffle = shuffle
        self.drop_last = drop_last

        self.lengths = [len(d) for d in self.datasets]
        self.n_batches = [
            (n // batch_size) if drop_last else -(-n // batch_size)
            for n in self.lengths]
        self.n_total_batch = sum(self.n_batches)
        if prob is None:
            if self.n_total_batch == 0:
                raise ValueError(
                    f"no dataset yields a full batch of {batch_size} "
                    f"(lengths {self.lengths}, drop_last={drop_last})")
            prob = [n / self.n_total_batch for n in self.n_batches]
        self.prob = np.asarray(prob, np.float64)

        # task -> [(ds_idx, prob)], insertion-ordered like the reference's
        # defaultdict over output_type (mixed_sampler.py:76-83)
        tasks = defaultdict(list)
        for i, ds in enumerate(self.datasets):
            tasks[ds.output_type].append((i, float(self.prob[i])))
        self.tasks = dict(tasks)
        self.task_keys = list(self.tasks.keys())

        self.reset()

    def reset(self):
        self.step = 0
        self._queues: List[List[List[int]]] = [[] for _ in self.datasets]
        self._pass_idx = [0] * len(self.datasets)

    # -- internals -------------------------------------------------------

    def _refill(self, ds_idx: int):
        n = self.lengths[ds_idx]
        rng = np.random.default_rng(
            np.random.SeedSequence(
                [self.seed, 7919, ds_idx, self._pass_idx[ds_idx]]))
        order = rng.permutation(n) if self.shuffle else np.arange(n)
        self._pass_idx[ds_idx] += 1
        bs = self.batch_size
        end = n - n % bs if self.drop_last else n
        batches = [list(order[i: i + bs]) for i in range(0, end, bs)]
        batches.reverse()  # pop() from the end, like the reference list.pop()
        self._queues[ds_idx] = batches

    def _draw(self, step: int) -> int:
        """Dataset index for micro-batch `step` (pure in (seed, step)).

        The reference draws the dataset multinomial — and, in
        non-iterative mode, the task — PER MICRO-BATCH from its stateful
        generator (mixed_sampler.py:90-105): one effective batch shares a
        task but mixes that task's datasets across its micro-batches. The
        choice draws are therefore seeded by the micro `step`; seeding by
        the effective index would repeat one dataset for all
        accumulation_steps micro-batches — a materially different
        training data distribution.
        """
        eff = step // self.accumulation_steps
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, 104729, step]))
        n_tasks = len(self.task_keys)
        if self.iterative_sampling:
            task_idx = eff % n_tasks  # task IS shared per eff batch (:93)
        else:
            task_idx = int(rng.integers(n_tasks))
        entries = self.tasks[self.task_keys[task_idx]]
        p = np.array([e[1] for e in entries], np.float64)
        p /= p.sum()
        return entries[int(rng.choice(len(entries), p=p))][0]

    # -- protocol --------------------------------------------------------

    def __len__(self):
        return self.n_total_batch

    def __next__(self) -> Tuple[int, List[int]]:
        ds_idx = self._draw(self.step)
        if not self._queues[ds_idx]:
            self._refill(ds_idx)
        if not self._queues[ds_idx]:
            raise ValueError(
                f"dataset {ds_idx} has {self.lengths[ds_idx]} samples — "
                f"fewer than one batch of {self.batch_size} with "
                f"drop_last; cannot produce a full batch")
        batch = self._queues[ds_idx].pop()
        self.step += 1
        return ds_idx, batch

    def __iter__(self):
        return self

    def fast_forward(self, n_steps: int):
        """Resume support: replay the schedule to micro-step n_steps
        (replaces the reference's skip_first_batches, data_loader.py:24-111)."""
        self.reset()
        for _ in range(n_steps):
            next(self)
