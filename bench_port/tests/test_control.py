"""The output check's control: the reference computed one precision
below the configuration's bfloat16 (every product's operands rounded to
fp8 e4m3) must fail the check, where the bf16 program passes it.

On the CPU at the tiny preset, three seeds: the control's gap is at
least 3x the bf16 program's and above the cells' limit. On the card
(`card` marker) at the cells' own size the same, with `calibrate.py`'s
readings: the numbers behind the limits (PERF.md)."""

import json
import os
import subprocess
import sys

import pytest
import torch

from bench_port.harness import cells, program
from bench_port.harness.check import worst_rel_l2
from bench_port.harness.refcheck import plain_reference
from bench_port.reference.precision import precision
from bench_port.tests.bench_helpers import tiny_config

SEEDS = (2**31 + 1, 2**31 + 2, 2**31 + 3)
INFER_CELLS = {"stablemtl-ms-sd2": "ms-infer-b8",
               "stablemtl-s-sd2": "s-infer-b8"}


@pytest.mark.parametrize("name", sorted(INFER_CELLS))
def test_control_fails_where_bf16_passes_tiny(name):
    torch.set_num_threads(min(4, torch.get_num_threads()))
    limit = cells.find(INFER_CELLS[name]).limits["worst_rel_l2"]
    cfg = tiny_config(name, "bfloat16")
    pipe = program.build_program(cfg, "cpu", (32, 32))
    for seed in SEEDS:
        program.load_program(pipe, cfg, seed, "cpu")
        x = torch.from_numpy(program.draw_images(seed, 2, (32, 32), "cpu"))
        out = pipe.infer_all_tasks(x, None).float().numpy()
        ref = plain_reference(cfg, seed, "cpu")
        want = ref.infer_all_tasks(x, None).numpy()
        with precision("fp8"):
            control = ref.infer_all_tasks(x, None).numpy()
        bf16_gap = worst_rel_l2(out, want)
        control_gap = worst_rel_l2(control, want)
        assert control_gap >= 3 * bf16_gap, (seed, bf16_gap, control_gap)
        assert control_gap > limit, (seed, control_gap, limit)


@pytest.mark.card
@pytest.mark.parametrize("workload", sorted(INFER_CELLS.values()))
def test_control_fails_at_the_cells_size_on_the_card(workload, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the cell's size runs only there")
    out = tmp_path / "cal.jsonl"
    subprocess.run([sys.executable, os.path.join(cells.BENCH_DIR,
                                                 "calibrate.py"),
                    "--workload", workload, "--seeds", "7",
                    "--control-seeds", ",".join(map(str, SEEDS)),
                    "--out", str(out)], check=True, timeout=1800)
    lines = [json.loads(x) for x in out.read_text().splitlines()]
    limit = cells.find(workload).limits["worst_rel_l2"]
    for line in lines:
        if line["side"] == "control":
            assert line["worst_rel_l2"] > limit
        else:
            assert line["worst_rel_l2"] <= limit


def test_train_control_fails_tiny():
    """The training cell's control at the tiny preset: the fp8 reference
    in the program's place fails at least one of the numbers compared."""
    from bench_port import calibrate
    from bench_port.tests.bench_helpers import tiny_context

    torch.set_num_threads(min(4, torch.get_num_threads()))
    ctx = tiny_context("ms-train-mb16", micro_batch=2, pool=6,
                       height=32, width=48)
    lines = []
    args = type("Args", (), dict(seeds="", control_seeds=str(SEEDS[0]),
                                 fault_seeds="", device="cpu"))
    calibrate.train_readings(ctx.cell, args, lines.append)
    (line,) = lines
    assert line["side"] == "control"
    assert any(line[k] > v for k, v in ctx.cell.limits.items()), line
