"""Profiling helpers: traces through `torch.profiler`, step timing, and
the program's own spans and counters. Counterpart of
`stablemtl_tpu/utils/profiling.py`.

Spans and counters: the program names its regions with `span(name)`
(nested, per thread) and counts with `count(name, n)`. Unless a caller
has turned the recorder on (`recording()`) or a `torch.profiler` is
active, a span costs a module-global read and
`torch.autograd._profiler_enabled()`, a count the read alone. Under a
profiler a span is a `record_function`, so the trace shows it by name.
With the recorder on, each span is kept in memory with its thread, its
parent, its request id(s) and its host start and end as
`time.time_ns()`, which is the profiler's clock (a Kineto event's `ts`
in us plus the trace's `baseTimeNanoseconds`); a span given a CUDA
device also records a pair of CUDA events on the current stream, read
once the recording ends. A span never synchronises the device, and
nothing is written out: `recording()` returns what it kept.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import os
import threading
import time
from typing import Dict, Iterator, List, Optional

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
    """A named region that shows up in traces: `span(name)`."""
    return span(name)


@dataclasses.dataclass(frozen=True)
class Span:
    """One region the recorder kept. Host times are `time.time_ns()`;
    thread is the `threading.get_ident()` of the thread in it (None for a
    span no one thread was in); device_ms is the CUDA events' elapsed
    time, None for a host span or one entered while a stream was being
    captured."""
    name: str
    id: int
    parent: Optional[int]
    thread: Optional[int]
    request: object
    start_ns: int
    end_ns: int
    device_ms: Optional[float] = None

    @property
    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6


class Recording:
    """What the recorder keeps over one `recording()`: `spans` (in the
    order they ended) and `counters` {name: total}, filled in when the
    recording ends."""

    def __init__(self):
        self.spans: List[Span] = []
        self.counters: Dict[str, int] = {}
        self._pending = []  # (span fields, start event, end event)
        self._ids = itertools.count(1)
        self._lock = threading.Lock()
        self._open = True

    def _add(self, fields: dict, events=None) -> None:
        with self._lock:
            if not self._open:
                return
            if events is None:
                self.spans.append(Span(**fields))
            else:
                self._pending.append((fields, events))

    def _count(self, name: str, n: int) -> None:
        with self._lock:
            if self._open:
                self.counters[name] = self.counters.get(name, 0) + n

    def _close(self) -> None:
        with self._lock:
            self._open = False
            pending, self._pending = self._pending, []
        for fields, (start, end) in pending:
            end.synchronize()
            self.spans.append(Span(**fields,
                                   device_ms=start.elapsed_time(end)))
        self.spans.sort(key=lambda s: s.end_ns)


_recorder: Optional[Recording] = None  # the recording on, if any
_recorder_lock = threading.Lock()
_local = threading.local()  # .stack: ids of this thread's open spans


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _NoSpan:
    """The span of a stretch with neither the recorder nor a profiler on:
    it does nothing."""
    id = None
    start_ns = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class _Span:
    def __init__(self, name: str, device, request):
        self.name, self.device, self.request = name, device, request
        self.id = self.start_ns = None
        self._rec = self._function = self._events = None

    def __enter__(self):
        if torch.compiler.is_compiling():  # torch.export, torch.compile
            return self
        rec = self._rec = _recorder
        if rec is not None:
            stack = _stack()
            self.id = next(rec._ids)
            self._parent = stack[-1] if stack else None
            stack.append(self.id)
            device = self.device
            if device is not None and torch.device(device).type == "cuda" \
                    and not torch.cuda.is_current_stream_capturing():
                self._events = (torch.cuda.Event(enable_timing=True),
                                torch.cuda.Event(enable_timing=True))
        if torch.autograd._profiler_enabled():
            self._function = torch.profiler.record_function(self.name)
            self._function.__enter__()
        # the stamps lie next to the profiler's own, the events inside them
        if rec is not None:
            self.start_ns = time.time_ns()
            if self._events is not None:
                self._events[0].record(torch.cuda.current_stream(
                    self.device))
        return self

    def __exit__(self, *exc):
        rec = self._rec
        if rec is not None:
            if self._events is not None:
                self._events[1].record(torch.cuda.current_stream(
                    self.device))
            end_ns = time.time_ns()
        if self._function is not None:
            self._function.__exit__(*exc)
        if rec is not None:
            _stack().pop()
            rec._add(dict(name=self.name, id=self.id, parent=self._parent,
                          thread=threading.get_ident(),
                          request=self.request, start_ns=self.start_ns,
                          end_ns=end_ns), self._events)
        return False


def span(name: str, *, device=None, request=None):
    """A context manager naming a region of the program (see the module's
    docstring). device: the device the region's work runs on; a CUDA
    device gets a pair of events on its current stream while the recorder
    is on (host stamps alone while that stream is being captured).
    request: the id, or a tuple of ids, of the requests the region
    serves. The entered span's `id` and `start_ns` are None unless the
    recorder is on."""
    if _recorder is None and not torch.autograd._profiler_enabled():
        return _NO_SPAN
    return _Span(name, device, request)


def record(name: str, start_ns: int, end_ns: int, *, request=None,
           parent: Optional[int] = None,
           thread: Optional[int] = None) -> Optional[int]:
    """Keep a span whose start and end were stamped elsewhere
    (`time.time_ns()`): a request's wait in a queue, from the thread that
    submitted it to the one that took it. thread: the thread that was in
    the span from start to end, if one was (None: the span is no
    thread's). Returns its id; nothing is kept, and None returned, while
    the recorder is off."""
    rec = _recorder
    if rec is None or torch.compiler.is_compiling():
        return None
    span_id = next(rec._ids)
    rec._add(dict(name=name, id=span_id, parent=parent, thread=thread,
                  request=request, start_ns=int(start_ns),
                  end_ns=int(end_ns)))
    return span_id


def count(name: str, n=1) -> None:
    """Add n to counter `name` while the recorder is on. n may be a
    function of no arguments that gives it, called only then: a count
    that costs work to make costs nothing while the recorder is off."""
    rec = _recorder
    if rec is not None and not torch.compiler.is_compiling():
        rec._count(name, int(n() if callable(n) else n))


def settle(device) -> Optional[int]:
    """While the recorder is on: wait until the work queued so far on
    `device`'s current stream has run, for a CUDA device (an event's
    `synchronize`), and return `time.time_ns()` then, where a span may
    end or start. None while it is off. Call it only where the caller
    waits for that work next anyway (a copy to the host)."""
    if _recorder is None:
        return None
    if torch.device(device).type == "cuda":
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(device))
        event.synchronize()
    return time.time_ns()


@contextlib.contextmanager
def recording() -> Iterator[Recording]:
    """Turn the recorder on for the block; yields the `Recording`, whose
    spans and counters are filled in when the block ends (the CUDA
    events' times are read then: each is waited for, so the caller
    synchronises first to keep the wait out of its own timing). One
    recording at a time."""
    global _recorder
    rec = Recording()
    with _recorder_lock:
        if _recorder is not None:
            raise RuntimeError("a recording is on already")
        _recorder = rec
    try:
        yield rec
    finally:
        with _recorder_lock:
            _recorder = None
        rec._close()
