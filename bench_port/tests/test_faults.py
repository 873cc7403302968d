"""A run with its timed path broken underneath must come out not
correct. The harness's look for a card is skipped: the cell's kind runs
on the CPU at the tiny preset in float32, and `main.report` prints the
result line. Faults: an answer altered where it is produced (offline and
serving), and results handed to the wrong requests (serving)."""

import contextlib
import io
import json

import numpy as np
import pytest

import stablemtl_tpu_torch.serving as serving
from bench_port.harness import cells
from bench_port.harness.main import report
from bench_port.tests.bench_helpers import tiny_context
from stablemtl_tpu_torch.pipeline import StableMTLPipeline

OFFLINE = dict(batch=2, pool_batches=2, warmup_steps=1)
SERVE = dict(batch=2, rate=8.0, pool=8, check_requests=8, warmup_steps=1,
             max_delay_s=0.5, drain_s=20)


def result(workload, **mix):
    ctx = tiny_context(workload, seconds=1.0, **mix)
    res = cells.kind(ctx.cell.mix).run(ctx)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert report(ctx, res, "cpu") == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


def test_sound_runs_are_correct():
    for workload, mix in (("ms-infer-b8", OFFLINE),
                          ("ms-serve-poisson", SERVE)):
        line = result(workload, **mix)
        assert line["correct"] is True, line
        assert list(line)[-1] == "checks"


def test_an_altered_answer_is_not_correct(monkeypatch):
    real = StableMTLPipeline.infer_tasks

    def altered(self, *a, **kw):
        out = real(self, *a, **kw).clone()
        out[2, 0] = -out[2, 0]          # one task's map of one image
        return out

    monkeypatch.setattr(StableMTLPipeline, "infer_tasks", altered)
    for workload, mix in (("ms-infer-b8", OFFLINE),
                          ("ms-serve-poisson", SERVE)):
        line = result(workload, **mix)
        assert line["correct"] is False, line
        gap = line["checks"]["worst_rel_l2"]
        assert gap["value"] > gap["limit"]


def test_results_handed_to_the_wrong_requests_are_not_correct(monkeypatch):
    real = serving._infer_on_host
    mixed = []

    def rolled(pipe, frames):
        out = real(pipe, frames)
        if len({f.tobytes() for f in frames[0]}) > 1:
            mixed.append(1)
        return np.roll(out, 1, axis=1)  # each row gets its neighbour's maps

    monkeypatch.setattr(serving, "_infer_on_host", rolled)
    line = result("ms-serve-poisson", **SERVE)
    assert mixed, "no batch held two distinct images"
    assert line["correct"] is False, line


TRAIN = dict(micro_batch=2, pool=6, height=32, width=48)


def train_result():
    ctx = tiny_context("ms-train-mb16", seconds=0.5, **TRAIN)
    res = cells.kind(ctx.cell.mix).run(ctx)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert report(ctx, res, "cpu") == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


def test_a_sound_training_run_is_correct():
    line = train_result()
    assert line["correct"] is True, line
    assert set(line["checks"]) == {"loss_gap", "grad_gap", "grad_dir_gap",
                                   "change_gap", "mask_mismatches"}


def test_a_step_that_leaves_its_state_unchanged_is_not_correct(monkeypatch):
    from stablemtl_tpu_torch.train_state import Optimizer

    monkeypatch.setattr(Optimizer, "_apply", lambda self, grads: None)
    line = train_result()
    assert line["correct"] is False, line
    assert line["checks"]["change_gap"]["value"] == pytest.approx(1.0)


def test_half_the_batch_left_out_is_not_correct(monkeypatch):
    import stablemtl_tpu_torch.train_state as ts

    real = ts.masked_mean

    def half(x, mask, count=None):
        mask = mask.clone()
        mask[mask.shape[0] // 2:] = 0     # the mean over the first half
        return real(x, mask)

    monkeypatch.setattr(ts, "masked_mean", half)
    line = train_result()
    assert line["correct"] is False, line
    gap = line["checks"]["grad_dir_gap"]
    assert gap["value"] > gap["limit"]
