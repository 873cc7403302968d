"""A cell at the tiny preset on the CPU, for driving the harness without
a card."""

from __future__ import annotations

import copy
import dataclasses
import time

import torch

from bench_port.harness import cells
from bench_port.harness.main import Context


def merged(base: dict, over: dict) -> dict:
    """`base` with `over`'s values, a dict value merged into `base`'s dict
    under its key."""
    out = dict(base)
    for k, v in over.items():
        out[k] = merged(out[k], v) if isinstance(v, dict) else v
    return out


def shrunk(cfg: dict, dtype: str = "float32") -> dict:
    """A configuration shrunk by its reference's `TINY` (the program's
    tiny preset: the same topology at small widths), computing in
    `dtype`."""
    cfg = merged(copy.deepcopy(cfg), cells.reference_of(cfg).TINY)
    cfg["program_config"]["model"]["compute_dtype"] = dtype
    cfg["model"]["compute_dtype"] = dtype
    return cfg


def tiny_config(name: str, dtype: str = "float32") -> dict:
    """The configuration file `name`, `shrunk`."""
    return shrunk(cells.load_json(f"{cells.BENCH_DIR}/configs/{name}.json"),
                  dtype)


def tiny_context(workload: str, seconds: float = 0.5, seed: int = 5,
                 dtype: str = "float32", **mix) -> Context:
    """A context for a kind's `run` on the CPU: the cell of BENCHMARK.json
    at the tiny preset, 32x32 images, the mix's other parameters as
    given."""
    cell = cells.find(workload)
    tiny_mix = {**cell.mix, "height": 32, "width": 32, **mix}
    cell = dataclasses.replace(cell, config=shrunk(cell.config, dtype),
                               mix=tiny_mix)
    torch.set_num_threads(min(4, torch.get_num_threads()))
    return Context(cell=cell, seed=seed, seconds=seconds, trace=False,
                   t_start=time.perf_counter(), device="cpu")

