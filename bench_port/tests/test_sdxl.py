"""The SDXL configuration `stablemtl-ms-sdxl` and its cell
`ms-sdxl-infer-b4`: found by name, shrunk by its reference's `TINY`,
conditioned through `load_program` (the text and the pooled table), run
by the offline kind on the CPU, and counted at full size on the meta
device against constants recorded when the cell was added."""

import collections
import contextlib
import dataclasses
import hashlib
import io
import json

import pytest
import torch

from bench_port.harness import cells, program
from bench_port.harness.main import report
from bench_port.reference import sdxl
from bench_port.tests.bench_helpers import shrunk, tiny_config, tiny_context
from bench_port.workcount.count import infer_work

CELL = "ms-sdxl-infer-b4"
SEED = 2**31 + 19
# the cell's step at full size (batch 4, 1024x1024), counted by
# workcount/count.py on reference/sdxl.py: FLOPs, attention calls and the
# calls' SHA-256
WORK = (668073969319936, 288,
        "ca4d0096a56ef8737c5de2192b864896f592587c863d54dfa6b4c277738fa157")


def test_the_configuration_resolves_and_shrinks():
    cell = cells.find(CELL)
    assert cells.reference_of(cell.config) is sdxl
    assert cell.config["reduced"] == [] and cell.chips == 1
    assert (cell.mix["kind"], cell.mix["batch"], cell.mix["height"],
            cell.mix["width"]) == ("offline", 4, 1024, 1024)
    cfg = shrunk(cell.config)
    assert cfg["program_config"]["model"]["size_preset"] == "sdxl_tiny"
    assert cfg["model"]["unet_transformer_layers"] == [1, 2, 3]
    # the tiny program and the tiny reference have the same parameters
    pipe = program.build_program(cfg, "cpu", (32, 32))
    for key, module in sdxl.build(cfg, "meta").items():
        prog = {"vae": pipe.vae, "unet": pipe.unet,
                "child": pipe.unet_child}[key]
        assert {n: tuple(p.shape) for n, p in module.named_parameters()} \
            == {n: tuple(p.shape) for n, p in prog.named_parameters()}, key


def test_load_program_sets_both_tables():
    cfg = tiny_config("stablemtl-ms-sdxl")
    pipe = program.build_program(cfg, "cpu", (32, 32))
    program.load_program(pipe, cfg, SEED, "cpu")
    cond = sdxl.conditioning(cfg, SEED, "cpu")
    assert {k: tuple(v.shape) for k, v in cond.items()} == {
        "text_embed_table": (7, 5, 32), "text_pooled_table": (7, 16)}
    for name, value in cond.items():
        have = getattr(pipe, name)
        assert torch.equal(have, value.to(have.dtype)), name
    # a pipeline without the pooled table (the SD2 layout's) is refused
    with pytest.raises(RuntimeError, match="text_pooled_table"):
        program.load_program(dataclasses.replace(pipe,
                                                 text_pooled_table=None),
                             cfg, SEED, "cpu")


def test_the_offline_kind_runs_the_tiny_cell_correct():
    ctx = tiny_context(CELL, seconds=1.0, seed=SEED, batch=2,
                       pool_batches=2, warmup_steps=1)
    res = cells.kind(ctx.cell.mix).run(ctx)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert report(ctx, res, "cpu") == 0
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert line["correct"] is True, line
    assert line["checks"]["worst_rel_l2"]["value"] < 1e-4


def test_the_cell_counts_as_recorded():
    cell = cells.find(CELL)
    got = infer_work(cell.config, 4, (1024, 1024))
    calls = got["attention"]
    assert got["flops"] == WORK[0] and len(calls) == WORK[1]
    assert hashlib.sha256(json.dumps([list(c) for c in calls]).encode()
                          ).hexdigest() == WORK[2]
    # per UNet pass (child, main) 60 blocks at 1024 tokens and 10 at 4096,
    # 7 streams of 4 images, 20 or 10 heads; the VAE's encode and 7
    # decodes at 16384 tokens, one head of 512
    assert collections.Counter(c[:4] for c in calls) == {
        (560, 1024, 1024, 64): 120, (560, 1024, 4, 64): 120,
        (280, 4096, 4096, 64): 20, (280, 4096, 4, 64): 20,
        (4, 16384, 16384, 512): 8}


def test_the_readers_of_the_tables_span_and_the_task_bytes():
    """kv_tables_ms.infer and task_gib.infer on the summary of a recorded
    tiny step (no device events on the CPU), then on a synthetic record;
    None where a record has no spans, as until the harness keeps them."""
    from bench_port.harness.spans import summary
    from stablemtl_tpu_torch.utils import profiling

    kv_ms, task_gib = (cells.reader(n) for n in ("kv_tables_ms.infer",
                                                 "task_gib.infer"))
    torch.set_num_threads(min(4, torch.get_num_threads()))
    cfg = tiny_config("stablemtl-ms-sdxl")
    pipe = program.build_program(cfg, "cpu", (32, 32))
    x = torch.from_numpy(program.draw_images(SEED, 2, (32, 32), "cpu"))
    with profiling.recording() as rec:
        for _ in range(2):
            pipe.infer_all_tasks(x, None)
    record = {"kind": "infer", "spans": summary(rec)}
    per_step = rec.counters["stablemtl.infer.task_bytes"] / 2
    assert task_gib(record) == per_step / 2**30 > 0
    assert kv_ms(record) is None
    record["spans"]["names"]["stablemtl.infer.kv_tables"]["device_ms"] = 3.0
    assert kv_ms(record) == 1.5
    for read in (kv_ms, task_gib):
        assert read({"kind": "infer"}) is None
        assert read({"kind": "train", "spans": record["spans"]}) is None
