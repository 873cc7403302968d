"""A cell at the tiny preset on the CPU, for driving the harness without
a card."""

from __future__ import annotations

import copy
import dataclasses
import time

import torch

from bench_port.harness import cells
from bench_port.harness.main import Context

TINY_MODEL = dict(unet_block_out_channels=[32, 64, 64, 64],
                  unet_attention_heads=[2, 2, 2, 2], cross_attention_dim=32,
                  norm_groups=8, vae_block_out_channels=[16, 32, 32, 32])


def tiny_config(name: str, dtype: str = "float32") -> dict:
    """The configuration file `name` at the program's tiny preset (the
    same topology at small widths), computing in `dtype`."""
    cfg = copy.deepcopy(cells.load_json(
        f"{cells.BENCH_DIR}/configs/{name}.json"))
    cfg["program_config"]["model"].update(size_preset="tiny",
                                          compute_dtype=dtype)
    cfg["model"].update(TINY_MODEL, compute_dtype=dtype)
    cfg["text_tokens"] = 5
    return cfg


def tiny_context(workload: str, seconds: float = 0.5, seed: int = 5,
                 dtype: str = "float32", **mix) -> Context:
    """A context for a kind's `run` on the CPU: the cell of BENCHMARK.json
    at the tiny preset, 32x32 images, the mix's other parameters as
    given."""
    cell = cells.find(workload)
    tiny_mix = {**cell.mix, "height": 32, "width": 32, **mix}
    cell = dataclasses.replace(cell, config=tiny_config(
        _config_name(workload), dtype), mix=tiny_mix)
    torch.set_num_threads(min(4, torch.get_num_threads()))
    return Context(cell=cell, seed=seed, seconds=seconds, trace=False,
                   t_start=time.perf_counter(), device="cpu")


def _config_name(workload: str) -> str:
    bench = cells.load_json(f"{cells.ROOT}/BENCHMARK.json")
    return {w["name"]: w["config"] for w in bench["workloads"]}[workload]
