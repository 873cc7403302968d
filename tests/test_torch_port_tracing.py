"""PyTorch port, its spans and counters (`utils.profiling`): the recorder
off and on, nesting across threads, counters, the shared clock with
`torch.profiler`, tracing by `torch.export`, and the spans of
`ServingSession` and the train step at the tiny single-stream preset on
the CPU. Imports no JAX; nothing is built."""

import contextlib
import glob
import json
import sys
import threading
import time

import numpy as np
import pytest
import torch

from stablemtl_tpu_torch.factory import build_pipeline
from stablemtl_tpu_torch.serving import ServingSession
from stablemtl_tpu_torch.train_state import (OptimizerConfig,
                                             create_train_state,
                                             make_train_step)
from stablemtl_tpu_torch.utils import profiling

HW = (16, 16)
TINY = {"model": {"size_preset": "tiny", "pretrained_path": "scratch"},
        "trainer": {"multi_stream": False}}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _by_name(rec):
    out = {}
    for s in rec.spans:
        out.setdefault(s.name, []).append(s)
    return out


def test_off_path_is_one_shared_noop():
    """With neither the recorder nor a profiler on, every span is the same
    inert object and counts go nowhere; a recording keeps nothing made
    before it began or after it ended."""
    assert profiling.span("a") is profiling.span("b", request=3)
    with profiling.span("a") as s:
        assert s.id is None and s.start_ns is None
    profiling.count("a")
    profiling.record("a", 0, 1)
    with profiling.recording() as rec:
        pass
    with profiling.span("late"):
        profiling.count("late")
    assert rec.spans == [] and rec.counters == {}


def test_spans_nest_per_thread_and_carry_requests():
    """Parents are the enclosing span of the same thread: a thread's first
    span has none, whatever the other thread has open."""
    both_open = threading.Barrier(2, timeout=10)

    def other():
        with profiling.span("t.outer"):
            with profiling.span("t.inner", request=(4, 5)):
                both_open.wait()

    with profiling.recording() as rec:
        with profiling.span("outer") as outer:
            t = threading.Thread(target=other)
            t.start()
            with profiling.span("inner", request=7):
                both_open.wait()
            t.join(timeout=10)
            profiling.record("queue", outer.start_ns - 10, outer.start_ns,
                             request=9, parent=outer.id)
    assert not t.is_alive()
    s = {k: v[0] for k, v in _by_name(rec).items()}
    assert s["outer"].parent is None and s["t.outer"].parent is None
    assert s["inner"].parent == s["outer"].id
    assert s["t.inner"].parent == s["t.outer"].id
    assert s["inner"].request == 7 and s["t.inner"].request == (4, 5)
    assert s["t.inner"].thread == s["t.outer"].thread != s["outer"].thread
    assert s["queue"].parent == s["outer"].id and s["queue"].host_ms == 1e-5
    assert s["outer"].start_ns <= s["inner"].start_ns <= s["inner"].end_ns \
        <= s["outer"].end_ns
    assert len({x.id for x in rec.spans}) == 5
    assert all(x.device_ms is None for x in rec.spans)


def test_counters_sum_over_threads():
    n_threads, n = 16, 500
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with profiling.recording() as rec:
            threads = [threading.Thread(target=lambda: [
                profiling.count("n", 2) for _ in range(n)])
                for _ in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=30)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    assert rec.counters == {"n": 2 * n * n_threads}


def test_span_stamps_lie_on_the_profilers_clock(tmp_path):
    """A span's own stamps against the profiler's record of the same span
    in the trace `profiling.trace` writes: a Kineto event's `ts` (us) plus
    the trace's `baseTimeNanoseconds` is `time.time_ns()`. The median
    over five spans, so that one preempted stamp on a busy host does not
    decide."""
    with profiling.trace(str(tmp_path)):
        with profiling.span("warm-up"):  # the profiler's first hooks
            torch.ones(64, 64).sum()
        with profiling.recording() as rec:
            for i in range(5):
                with profiling.span(f"mark{i}"):
                    torch.ones(64, 64).sum()
                    time.sleep(0.002)
    (path,) = glob.glob(str(tmp_path / "*.pt.trace.json"))
    with open(path) as f:
        trace = json.load(f)
    base = int(trace["baseTimeNanoseconds"])
    events = {e["name"]: e for e in trace["traceEvents"]
              if e.get("cat") == "user_annotation"}
    offsets = []
    for s in rec.spans:
        e = events[s.name]
        start = round(float(e["ts"]) * 1e3) + base
        end = start + round(float(e["dur"]) * 1e3)
        offsets.append((abs(start - s.start_ns), abs(end - s.end_ns)))
    assert len(offsets) == 5
    assert np.median(offsets, axis=0).max() < 2e6, offsets


def test_export_traces_no_span():
    """Under `torch.export` a span is inert, recorder and profiler on:
    the graph holds no profiler op and the recorder no span."""
    class Scaled(torch.nn.Module):
        def forward(self, x):
            with profiling.span("scaled", device=x.device):
                return x * 2

    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiling.recording() as rec:
            program = torch.export.export(Scaled(), (torch.ones(3),),
                                          strict=False)
    targets = [str(n.target) for n in program.graph.nodes
               if n.op == "call_function"]
    assert targets == ["aten.mul.Tensor"] and rec.spans == []


@pytest.fixture(scope="module")
def pipe():
    return build_pipeline(TINY, seed=0, device="cpu", image_hw=HW)


def _serve(pipe, images, recorded: bool):
    """Results, submit times and result times (time_ns) of `images` sent
    to a batch-2 session at once, and the recording when `recorded`."""
    sent, done = [], {}
    # the session closes inside the recording: its collector keeps a
    # group's spans once the group's futures are resolved
    with (profiling.recording() if recorded
          else contextlib.nullcontext()) as rec:
        with ServingSession(pipe, batch=2, max_delay_s=0.01) as sess:
            futures = []
            for i, im in enumerate(images):
                sent.append(time.time_ns())
                fut = sess.submit(im)
                fut.add_done_callback(
                    lambda f, i=i: done.setdefault(i, time.time_ns()))
                futures.append(fut)
            results = [f.result(timeout=60) for f in futures]
    return results, sent, done, rec


def test_serving_spans_and_counters_and_results_unchanged(pipe):
    """3 requests at batch 2: a queue span each, from its submit to the
    start of its group's step (a `serve.step` span holding its id, the
    queue span's parent), no longer than its latency; requests plus
    padding rows fill every step; a copy span a step; and the results
    bit-equal to a session's with the recorder off."""
    r = np.random.RandomState(3)
    images = [r.uniform(-1, 1, HW + (3,)).astype(np.float32)
              for _ in range(3)]
    got, sent, done, rec = _serve(pipe, images, recorded=True)
    want, *_ = _serve(pipe, images, recorded=False)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    spans = _by_name(rec)
    c = rec.counters
    steps = c["stablemtl.serve.steps"]
    assert c["stablemtl.serve.requests"] == 3
    assert c["stablemtl.serve.requests"] + c["stablemtl.serve.padding_rows"] \
        == steps * 2
    assert len(spans["stablemtl.serve.step"]) == steps
    assert len(spans["stablemtl.serve.copy"]) == steps
    step_of = {s.id: s for s in spans["stablemtl.serve.step"]}
    copies = {r: s for s in spans["stablemtl.serve.copy"]
              for r in s.request}
    queued = sorted(spans["stablemtl.serve.queue"], key=lambda s: s.request)
    assert [s.request for s in queued] == [0, 1, 2]
    for i, q in enumerate(queued):
        step = step_of[q.parent]
        copy = copies[q.request]
        assert q.request in step.request and q.end_ns == step.start_ns
        assert step.end_ns == copy.start_ns
        assert sent[i] <= q.start_ns <= q.end_ns <= done[i] <= copy.end_ns
        assert q.end_ns - q.start_ns <= done[i] - sent[i]
    assert {s.name for s in rec.spans} >= {
        "stablemtl.infer.encode", "stablemtl.infer.child",
        "stablemtl.infer.main", "stablemtl.infer.decode"}


def test_train_micro_step_bit_equal_with_the_recorder_on():
    """A micro-step and its update with the recorder off and on leave
    every parameter bit-equal; the recorded one holds a forward, a
    backward and an update span, the optimizer's clip and Adam
    (`train.apply`) nested in the update."""
    r = np.random.RandomState(4)
    batch = {k: r.uniform(-1, 1, (1,) + HW + (3,)).astype(np.float32)
             for k in ("rgb_norm", "rgb_next_norm", "target_3ch")}
    batch.update(valid_mask=np.ones((1,) + HW + (1,), bool), task_idx=2)
    params = []
    for recorded in (False, True):
        tpipe = build_pipeline(TINY, seed=0, device="cpu", image_hw=HW,
                               trainable=True)
        state = create_train_state(tpipe.unet, OptimizerConfig(
            warmup_steps=0))
        step = make_train_step(tpipe, base_seed=3)
        with (profiling.recording() if recorded
              else contextlib.nullcontext()) as rec:
            state, _ = step(state, batch)
        params.append([p.detach().clone() for p in state.params.values()])
    for a, b in zip(*params):
        assert torch.equal(a, b)
    spans = {k: v[0] for k, v in _by_name(rec).items()}
    assert spans["stablemtl.train.apply"].parent == \
        spans["stablemtl.train.update"].id
    for name in ("forward", "backward"):
        assert spans[f"stablemtl.train.{name}"].end_ns <= \
            spans["stablemtl.train.update"].start_ns
