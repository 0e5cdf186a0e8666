"""Spans, counters, per-stage timing, logging and profiling hooks.

The port's counterpart of ``innfer_tpu/observability.py``: a tracer of
spans and counters inside the frame path and the directory loop, recorded
while a ``torch.profiler`` is recording (:class:`Tracer`); stage timers
(host wall clock around the directory loop's sections); the
``innfer_tpu_torch`` logger and a ``torch.profiler`` trace context.

The JAX package's ``enable_compilation_cache`` is not carried: it turns on
XLA's persistent compilation cache, and PyTorch runs eagerly with nothing
to compile per shape.  Its ``device_sync`` (a scalar fetch, for tunneled
TPU platforms where ``block_until_ready`` could return early) is
``torch.cuda.synchronize`` here.
"""
from __future__ import annotations

import contextlib
import itertools
import logging
import os
import threading
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple, Union

import torch
from torch.autograd import profiler as _autograd_profiler

logger = logging.getLogger("innfer_tpu_torch")
if not logger.handlers:
    _h = logging.StreamHandler()
    _h.setFormatter(logging.Formatter("%(asctime)s %(name)s %(levelname)s %(message)s"))
    logger.addHandler(_h)
    logger.setLevel(logging.INFO)

# a request id: one image's, or a group's tuple of its images' ids
Request = Union[int, Tuple[int, ...], None]


class SpanRecord:
    """One finished (or open: ``t1`` None) span: its name, request id,
    parent record, host start and end (``perf_counter_ns``) and, on a CUDA
    device, its pair of timing events."""

    __slots__ = ("name", "request", "parent", "t0", "t1", "events")

    def __init__(self, name: str, request: Request, parent: Optional["SpanRecord"],
                 t0: int, events=None):
        self.name, self.request, self.parent = name, request, parent
        self.t0, self.t1, self.events = t0, None, events

    def device_ms(self) -> Optional[float]:
        """Milliseconds on the device's stream between the span's two
        events; None without events.  Waits for the end event."""
        if self.events is None:
            return None
        start, end = self.events
        end.synchronize()
        return start.elapsed_time(end)


def span_table(records: List[SpanRecord]) -> Dict[str, dict]:
    """Per span name: the count, host ms, device ms (None where no record
    of the name has events) and device self ms (each record's device ms
    less that of its children with events)."""
    done = [r for r in records if r.t1 is not None]
    dev = {id(r): r.device_ms() for r in done}
    child: Dict[int, float] = defaultdict(float)
    for r in done:
        if r.parent is not None and dev[id(r)] is not None:
            child[id(r.parent)] += dev[id(r)]
    table: Dict[str, dict] = {}
    for r in done:
        row = table.setdefault(r.name, {"count": 0, "host_ms": 0.0, "device_ms": None,
                                        "device_self_ms": None})
        row["count"] += 1
        row["host_ms"] += (r.t1 - r.t0) / 1e6
        d = dev[id(r)]
        if d is not None:
            row["device_ms"] = (row["device_ms"] or 0.0) + d
            row["device_self_ms"] = (row["device_self_ms"] or 0.0) + d - child[id(r)]
    return table


class Tracer:
    """Spans and counters inside the program, recorded only while a
    ``torch.profiler`` is recording (the CLI's ``--profile``, a benchmark's
    traced window): no flag of its own.  Off, a span costs one attribute
    read and a counter one branch.

    A span (:meth:`span`) opens a ``record_function`` of its name, so it
    lies on the profiler's timeline beside the device's operations, and
    keeps a :class:`SpanRecord` in memory: its parent is the thread's
    innermost open span, and its request id is the parent's, or a new one
    for a ``root`` span outside any request.  On a CUDA device it records
    a pair of timing events on the current stream, resolved only by
    :meth:`summary` (pooled; :meth:`reset` returns them)."""

    def __init__(self):
        self.records: List[SpanRecord] = []
        self.counters: Dict[str, int] = defaultdict(int)
        self._lock = threading.Lock()
        self._local = threading.local()
        self._ids = itertools.count(1)
        self._pool: Dict[int, List[torch.cuda.Event]] = defaultdict(list)

    def new_request(self) -> int:
        return next(self._ids)

    def _stack(self) -> List[SpanRecord]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _events(self, device: torch.device):
        with self._lock:
            free = self._pool[device.index if device.index is not None
                              else torch.cuda.current_device()]
            return tuple(free.pop() if free else torch.cuda.Event(enable_timing=True)
                         for _ in range(2))

    @contextlib.contextmanager
    def span(self, name: str, device: Optional[torch.device] = None, *,
             root: bool = False, request: Request = None):
        """The block as the span ``name``; ``device``: a CUDA device whose
        current stream takes the span's timing events; ``root``: a new
        request id outside any request; ``request``: this id instead."""
        if not _autograd_profiler._is_profiler_enabled:
            yield
            return
        stack = self._stack()
        parent = stack[-1] if stack else None
        if request is None and parent is not None:
            request = parent.request
        if request is None and root:
            request = self.new_request()
        with torch.profiler.record_function(name):
            events = stream = None
            if device is not None and device.type == "cuda":
                events = self._events(device)
                stream = torch.cuda.current_stream(device)
                events[0].record(stream)
            rec = SpanRecord(name, request, parent, time.perf_counter_ns(), events)
            self.records.append(rec)
            stack.append(rec)
            try:
                yield
            finally:
                stack.pop()
                if events is not None:
                    events[1].record(stream)
                rec.t1 = time.perf_counter_ns()

    def count(self, name: str, n: int) -> None:
        if _autograd_profiler._is_profiler_enabled:
            with self._lock:
                self.counters[name] += n

    def summary(self) -> dict:
        """``{"spans": {name: {count, host_ms, device_ms, device_self_ms}},
        "counters": {name: n}}`` over everything recorded since
        :meth:`reset`; waits for the spans' end events."""
        table = span_table(list(self.records))
        with self._lock:
            counters = dict(self.counters)
        return {"spans": table, "counters": counters}

    def reset(self) -> None:
        with self._lock:
            for r in self.records:
                if r.events is not None and r.t1 is not None:
                    self._pool[r.events[0].device.index].extend(r.events)
            self.records = []
            self.counters.clear()

    def log_summary(self) -> None:
        """The summary as one table: span, count, host ms, device ms, self
        ms; then the counters."""
        s = self.summary()

        def ms(v):
            return "-" if v is None else f"{v:.3f}"

        rows = [f"{'span':<20} {'count':>7} {'host ms':>12} {'device ms':>12} {'self ms':>12}"]
        rows += [f"{name:<20} {r['count']:>7} {r['host_ms']:>12.3f} {ms(r['device_ms']):>12} "
                 f"{ms(r['device_self_ms']):>12}" for name, r in sorted(s["spans"].items())]
        rows += [f"counter {name:<12} {n}" for name, n in sorted(s["counters"].items())]
        logger.info("trace summary\n%s", "\n".join(rows))


TRACER = Tracer()
span = TRACER.span
count = TRACER.count
summary = TRACER.summary
reset = TRACER.reset


def stage(timers: Optional["StageTimers"], name: str, **kw):
    """``timers.stage(name)`` where there are timers, else the span
    ``innfer.<name>`` alone."""
    return timers.stage(name, **kw) if timers is not None else span("innfer." + name, **kw)


class StageTimers:
    """Accumulate wall-clock seconds per named stage; ``report()`` returns
    a dict.  The encode pool's threads time their stages concurrently, so
    the totals are updated under a lock.  Each stage is also the tracer's
    span ``innfer.<name>``.

    The directory loop's stages (``InferenceSession.process``): ``read``
    waits for a decode, ``image`` and ``batch`` enqueue one image's or one
    group's device work (the host returns before the card finishes),
    ``encode_wait`` waits for the oldest encode at the bound on outputs in
    flight, ``fetch`` waits for the pinned u8 copy, which waits for the
    device, and ``encode`` writes the PNG."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def stage(self, name: str, **kw):
        """Time the block as ``name``, inside the span ``innfer.<name>``
        (``kw``: :meth:`Tracer.span`'s)."""
        t0 = time.perf_counter()
        try:
            with span("innfer." + name, **kw):
                yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self.totals[name] += dt
                self.counts[name] += 1

    def report(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            return {
                name: {
                    "total_s": round(self.totals[name], 4),
                    "count": self.counts[name],
                    "mean_ms": round(1e3 * self.totals[name] / max(self.counts[name], 1), 2),
                }
                for name in self.totals
            }

    def log_report(self) -> None:
        for name, row in sorted(self.report().items()):
            logger.info("stage %-16s total=%7.3fs n=%-4d mean=%8.2fms",
                        name, row["total_s"], row["count"], row["mean_ms"])


TRACE_FILE = "trace.json"


@contextlib.contextmanager
def profile_trace(trace_dir: Optional[str]):
    """``torch.profiler`` over the block (host, and the card where there is
    one), written as a Chrome trace to ``trace_dir/trace.json``; the
    tracer records from a reset for the block's length.  A no-op when
    ``trace_dir`` is falsy."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    reset()
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, TRACE_FILE))
