"""The program's spans in a run (harness/spans.py, trace_spans.py): the
trace's clock, the idle time put down to spans, the span metrics'
readers on synthetic records, and an untraced recorded run of each kind
at the tiny preset on the CPU."""

import pytest

from bench_port import trace_spans
from bench_port.harness import cells
from bench_port.harness.spans import (OUTSIDE, idle_by_span, summary,
                                      to_ns)
from bench_port.tests.bench_helpers import tiny_context
from stablemtl_tpu_torch.utils.profiling import Recording, Span

BASE = 1_700_000_000_000_000_000


def ev(ts, dur, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": "k", "ts": ts, "dur": dur}


def span(name, start_us, end_us, thread=1, request=None, device_ms=None,
         sid=0):
    return Span(name=name, id=sid, parent=None, thread=thread,
                request=request, start_ns=to_ns(start_us, BASE),
                end_ns=to_ns(end_us, BASE), device_ms=device_ms)


def test_trace_time_maps_through_its_base():
    assert to_ns(1.5, BASE) == BASE + 1500
    assert to_ns("1483303539973.956", BASE) == BASE + 1483303539973956


def test_idle_is_put_down_to_the_launching_threads_spans():
    # device busy 10-20, 40-50, 70-80, 95-100 us of a stretch 0-100 us:
    # gaps 0-10, 20-40, 50-70, 80-95
    xs = [ev(10, 10), ev(40, 10), ev(70, 10), ev(95, 5),
          ev(0, 100, cat="cuda_runtime")]   # host-side: not device work
    spans = [span("stablemtl.train.forward", 0, 35),
             span("stablemtl.bank", 25, 35),         # nested in forward
             span("stablemtl.train.backward", 52, 90),
             span("stablemtl.train.update", 0, 100, thread=2)]  # another
    idle = idle_by_span(xs, BASE, (BASE, BASE + 100_000), spans, thread=1)
    assert idle == pytest.approx({
        "stablemtl.train.forward": 30e-6,   # 0-10 and 20-40 (mid 30)
        "stablemtl.bank": 20e-6,            # 20-40 only
        "stablemtl.train.backward": 35e-6,  # 50-70 and 80-95
    })
    idle = idle_by_span(xs, BASE, (BASE, BASE + 100_000), spans[:2],
                        thread=1)
    assert idle[OUTSIDE] == pytest.approx(35e-6)


def test_summary_sums_by_name_and_orders_the_queue():
    rec = Recording()
    rec.spans = [span("stablemtl.serve.queue", 0, 30, request=2),
                 span("stablemtl.serve.queue", 0, 10, request=1),
                 span("stablemtl.bank", 0, 1, device_ms=0.5),
                 span("stablemtl.bank", 0, 3, device_ms=0.25)]
    rec.counters = {"stablemtl.serve.steps": 1}
    s = summary(rec)
    assert s["queue_ms"] == pytest.approx([0.01, 0.03])
    assert s["names"]["stablemtl.bank"] == pytest.approx(
        {"count": 2, "host_ms": 0.004, "device_ms": 0.75})
    assert s["names"]["stablemtl.serve.queue"]["device_ms"] is None
    assert s["counters"] == {"stablemtl.serve.steps": 1}


RECORDS = {
    "infer": {"kind": "infer", "spans": {"queue_ms": [], "counters": {},
                                         "names": {
        "stablemtl.infer.encode": {"count": 4, "host_ms": 1.0,
                                   "device_ms": 200.0},
        "stablemtl.bank": {"count": 64, "host_ms": 9.0,
                           "device_ms": 480.0}}}},
    "serve": {"kind": "serve", "spans": {
        "queue_ms": [float(i) for i in range(1, 101)],
        "counters": {"stablemtl.serve.requests": 30,
                     "stablemtl.serve.padding_rows": 10,
                     "stablemtl.serve.steps": 5},
        "names": {"stablemtl.serve.copy": {"count": 5, "host_ms": 600.0,
                                           "device_ms": None}}},
        "idle_by_span": {"window_s": 4.0, "busy_s": 3.0,
                         "idle_s": {"stablemtl.serve.copy": 0.2}}},
    "train": {"kind": "train", "spans": {"queue_ms": [], "counters": {},
                                         "names": {
        "stablemtl.train.forward": {"count": 4, "host_ms": 800.0,
                                    "device_ms": None},
        "stablemtl.train.backward": {"count": 4, "host_ms": 1200.0,
                                     "device_ms": None},
        "stablemtl.train.update": {"count": 4, "host_ms": 100.0,
                                   "device_ms": 160.0}}},
        "idle_by_span": {"window_s": 2.0, "busy_s": 1.0,
                         "idle_s": {"stablemtl.train.forward": 0.3,
                                    "stablemtl.train.backward": 0.5,
                                    "stablemtl.train.update": 0.1,
                                    OUTSIDE: 0.1}}},
}
WANT = {"encode_ms.infer": 50.0, "banks_ms.infer": 120.0,
        "queue_wait_p95_ms.serve": 95.0, "fill.serve": 75.0,
        "copy_ms.serve": 120.0, "idle_copy.serve": 5.0,
        "fwd_host_ms.train": 200.0, "bwd_host_ms.train": 300.0,
        "update_host_ms.train": 25.0, "idle_fwd.train": 15.0,
        "idle_bwd.train": 25.0, "idle_update.train": 5.0}


@pytest.mark.parametrize("metric", trace_spans.SPAN_METRICS)
def test_each_span_reader_on_a_synthetic_record(metric):
    assert set(WANT) == set(trace_spans.SPAN_METRICS)
    read = cells.reader(metric)
    kind = metric.rsplit(".", 1)[1]
    assert read(RECORDS[kind]) == pytest.approx(WANT[metric])
    for other, record in RECORDS.items():
        if other != kind:
            assert read(record) is None
    # a record without the program's spans (a program without them, or
    # the benchmark's own traced run) reads nothing
    bare = {k: v for k, v in RECORDS[kind].items()
            if k not in ("spans", "idle_by_span")}
    assert read(bare) is None


RUNS = {
    "ms-infer-b8": dict(batch=2, pool_batches=2, warmup_steps=1),
    "ms-serve-poisson": dict(batch=2, rate=8.0, pool=8, check_requests=2,
                             warmup_steps=1, max_delay_s=0.5, drain_s=20),
    "ms-train-mb16": dict(micro_batch=2, pool=6, height=32, width=48),
}


@pytest.mark.parametrize("workload", sorted(RUNS))
def test_an_untraced_recorded_run_on_the_cpu(workload):
    """The window's spans of a kind's run: on the CPU no span has device
    times, so the inference readers read nothing, the others a number."""
    ctx = tiny_context(workload, seconds=1.0, **RUNS[workload])
    res, out = trace_spans.run_recorded(ctx)
    got = out["span_metrics"]
    if workload == "ms-infer-b8":
        assert got == {}
        assert out["names"]["stablemtl.bank"]["count"] == \
            16 * out["names"]["stablemtl.infer.encode"]["count"]
    elif workload == "ms-serve-poisson":
        assert set(got) == {"queue_wait_p95_ms.serve", "fill.serve",
                            "copy_ms.serve"}
        c = out["counters"]
        assert c["stablemtl.serve.requests"] == res["attempted"]
        d = out["decomposition"]
        assert d["requests"] == res["attempted"]
        assert d["sum_ms"] == pytest.approx(d["latency_ms"], rel=1e-3)
    else:
        assert set(got) == {"fwd_host_ms.train", "bwd_host_ms.train",
                            "update_host_ms.train"}
        assert out["names"]["stablemtl.train.forward"]["count"] * 2 == \
            res["attempted"]
    assert all(v > 0 for v in got.values())
