"""Profiling helpers: traces through `torch.profiler` and step timing.
Counterpart of `stablemtl_tpu/utils/profiling.py`."""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Trace the host and, when CUDA is available, the card; the trace is
    written to `log_dir` as `<host>_<pid>.<time>.pt.trace.json` (TensorBoard
    or Perfetto reads it). Yields the profiler: its `key_averages()` sum
    the time by op and kernel once the block has ended."""
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                log_dir)) as prof:
        yield prof


def _synchronize():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class StepTimer:
    """EMA step timer; `with timer: ...` around each step. It synchronizes
    the card on entry and exit, so a step's time is its device work's, not
    the time to enqueue it."""

    def __init__(self, ema: float = 0.9):
        self.ema = ema
        self.value: Optional[float] = None
        self._t0 = 0.0

    def __enter__(self):
        _synchronize()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        _synchronize()
        dt = time.perf_counter() - self._t0
        self.value = dt if self.value is None else \
            self.ema * self.value + (1 - self.ema) * dt
        return False


def annotate(name: str):
    """A named region that shows up in traces."""
    return torch.profiler.record_function(name)
