"""Per-stage wall-clock timers, the program's spans, and the trace context
(port of `sr_livo_tpu/utils/profiling.py`).

PyTorch launches CUDA work asynchronously, so a host clock stopped right
after a stage measures only its enqueue.  A stage that launches device
work calls `synchronize()` before it ends: with `sync=True` (on a CUDA
device) that is `torch.cuda.synchronize()`, so the stage time includes
its device work; otherwise it does nothing.

Spans (`StageTimers(spans=True)` or `start_spans()`) time the program as
it runs, with no synchronize: each stage also records a `Span` (name,
frame, parent span, host start and end from `time.perf_counter_ns()`),
kept in memory and read out after the run.  A stage whose caller says
it enqueues device work (`with timers.stage(name), timers.on_device():`)
records a pair of timing events around its enqueue, on the stream that
was current when spans were turned on, from a pool made then; the pair
is read once its second event has completed (`query()`, never a wait),
which in a closed loop is by the next frame.  One clock: turning spans
on on a CUDA device synchronizes once and records an anchor event with
its host time, and each event's time is the anchor's host time plus
`elapsed_time` from the anchor event.  So host spans and the device
intervals of their work share one timeline, and a gap in the device's
work can be named by the host span that covers it (`busy`, `idle_gaps`,
`per_frame`).  Spans open no profiler range: under CUPTI a range is a
device annotation, which a trace reader could count as device work.

`trace_if_enabled` captures a `torch.profiler` trace of a region (host
ops, and the device's kernels where CUDA is available) as a Chrome trace
under `$LIVO_TRACE_DIR/<tag>/` when that variable is set, and the spans
of a `StageTimers` beside it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import threading
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

# Event pairs made when spans are turned on: more than a frame's device
# stages; a frame's pairs go back to the pool once read.
EVENT_PAIRS = 64
_NOTHING = contextlib.nullcontext()


@dataclasses.dataclass(eq=False)
class Span:
    """A timed region: `name`, `frame` (the pipeline's frame index, None
    before the first frame), `parent` (the id of the span it opened in,
    None for a root), host `start` and `end` in `perf_counter_ns()`, and
    `device`, the (start, end) of the work it enqueued on the device on
    the same clock, or None."""
    id: int
    name: str
    frame: Optional[int]
    parent: Optional[int]
    start: int
    end: Optional[int] = None
    device: Optional[Tuple[int, int]] = None
    events: Optional[tuple] = None          # the unread timing events


class StageTimers:
    """Accumulates wall-clock per named stage, and with spans on records
    each stage as a `Span`.  One per pipeline; spans are kept per thread
    (a feeder thread's stages are roots of their own)."""

    def __init__(self, sync: bool = False, device="cpu",
                 spans: bool = False):
        self.sync = sync
        self.device = torch.device(device)
        self.total: Dict[str, float] = defaultdict(float)
        self.count: Dict[str, int] = defaultdict(int)
        self.longest: Dict[str, float] = defaultdict(float)
        self.spans: Optional[List[Span]] = None      # None: spans off
        if spans:
            self.start_spans()

    def synchronize(self):
        """Wait for the device when `sync` is on (call inside a stage)."""
        if self.sync and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def stage(self, name: str):
        span = None if self.spans is None else self._open(name)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.total[name] += dt
            self.count[name] += 1
            self.longest[name] = max(self.longest[name], dt)
            if span is not None:
                self._close(span)

    def time_stage(self, name: str, fn, *args, **kwargs):
        """`fn(*args, **kwargs)` timed as stage `name` (synchronized when
        `sync` is on); returns its result."""
        with self.stage(name):
            out = fn(*args, **kwargs)
            self.synchronize()
        return out

    def report(self) -> Dict[str, Dict[str, float]]:
        return {
            name: {
                "total_s": self.total[name],
                "count": self.count[name],
                "mean_ms": 1000.0 * self.total[name] / max(self.count[name], 1),
                "max_ms": 1000.0 * self.longest[name],
            }
            for name in sorted(self.total)
        }

    def summary(self) -> str:
        lines = ["stage                    count   mean ms   total s"]
        for name, r in self.report().items():
            lines.append(f"{name:<24} {r['count']:>5} {r['mean_ms']:>9.2f} "
                         f"{r['total_s']:>9.2f}")
        return "\n".join(lines)

    # ---- spans ------------------------------------------------------------
    def start_spans(self) -> None:
        """Turn spans on (module docstring).  On a CUDA device: the event
        pool made now, and the clock's anchor (one synchronize)."""
        self._lock = threading.Lock()
        self._local = threading.local()
        self._unread: List[Span] = []
        self._free: list = []
        self._anchor = None
        if self.device.type == "cuda":
            self._stream = torch.cuda.current_stream(self.device)
            self._free = [torch.cuda.Event(enable_timing=True)
                          for _ in range(2 * EVENT_PAIRS)]
            torch.cuda.synchronize(self.device)
            anchor = torch.cuda.Event(enable_timing=True)
            anchor.record(self._stream)
            t = time.perf_counter_ns()
            anchor.synchronize()
            self._anchor = (anchor, t)
        self.spans = []

    def _stack(self) -> List[Span]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _event(self):
        with self._lock:
            if self._free:
                return self._free.pop()
        return torch.cuda.Event(enable_timing=True)     # the pool ran dry

    def _open(self, name: str, frame: Optional[int] = None,
              start: Optional[int] = None) -> Span:
        stack = self._stack()
        parent = stack[-1] if stack else None
        if frame is None:
            frame = (parent.frame if parent is not None
                     else getattr(self._local, "frame", None))
        with self._lock:
            span = Span(len(self.spans), name, frame,
                        None if parent is None else parent.id,
                        time.perf_counter_ns() if start is None else start)
            self.spans.append(span)
        stack.append(span)
        return span

    def _close(self, span: Span) -> None:
        self._stack().pop()
        span.end = time.perf_counter_ns()

    def on_device(self):
        """The stage open around this block enqueues device work: with
        spans on on a CUDA device, a pair of timing events around the
        block gives that span its device interval.  Use it only in a
        stage that holds no other such stage: a pair around several would
        count the device's waits between them as work.  Nothing with
        spans off."""
        if self.spans is None or self._anchor is None or not self._stack():
            return _NOTHING
        return self._device_pair(self._stack()[-1])

    @contextlib.contextmanager
    def _device_pair(self, span: Span):
        a = self._event()
        a.record(self._stream)
        try:
            yield
        finally:
            b = self._event()
            b.record(self._stream)
            span.events = (a, b)
            with self._lock:
                self._unread.append(span)

    def _read(self) -> None:
        """The device intervals of the spans whose work has completed;
        their events go back to the pool.  Never waits."""
        if self._anchor is None:
            return
        anchor, t0 = self._anchor
        with self._lock:
            unread, self._unread = self._unread, []
        left = []
        for span in unread:
            a, b = span.events
            if not b.query():
                left.append(span)
                continue
            span.device = (t0 + round(1e6 * anchor.elapsed_time(a)),
                           t0 + round(1e6 * anchor.elapsed_time(b)))
            span.events = None
            with self._lock:
                self._free += [a, b]
        with self._lock:
            self._unread = left + self._unread

    @contextlib.contextmanager
    def frame_span(self, frame: int, cut_start: Optional[int] = None):
        """Root span `frame` of the pipeline's frame `frame`; the spans
        opened within carry its frame index, as do this thread's later
        roots.  With `cut_start` (the `perf_counter_ns()` before the cut
        that made the frame), it starts there, with a child `cut` up to
        now.  Reads the device intervals of earlier frames first.
        Nothing with spans off."""
        if self.spans is None:
            yield
            return
        self._read()
        self._local.frame = frame
        span = self._open("frame", frame=frame, start=cut_start)
        if cut_start is not None:
            self._close(self._open("cut", start=cut_start))
        try:
            yield
        finally:
            self._close(span)

    @contextlib.contextmanager
    def for_frame(self, frame: int):
        """The spans this thread opens as roots within the block carry
        frame index `frame` (a feeder thread that prepares a later frame
        than the one being dispatched).  Nothing with spans off."""
        if self.spans is None:
            yield
            return
        before = getattr(self._local, "frame", None)
        self._local.frame = frame
        try:
            yield
        finally:
            self._local.frame = before

    def read_spans(self) -> List[Span]:
        """Every span so far, with every device interval (waits for the
        device: for after the run).  Empty with spans off."""
        if self.spans is None:
            return []
        if self._anchor is not None:
            torch.cuda.synchronize(self.device)
            self._read()
        return self.spans

    def busy(self, lo: int, hi: int) -> Tuple[int, List[Tuple[int, int]]]:
        """Busy ns of the union of the spans' device intervals within
        [lo, hi] (`perf_counter_ns()` times), and the idle gaps between
        them and at the ends.  Waits for the device (`read_spans`)."""
        total, end, gaps = 0, lo, []
        for a, b in sorted(s.device for s in self.read_spans()
                           if s.device is not None):
            a, b = max(a, lo), min(b, hi)
            if b <= a:
                continue
            if a > end:
                gaps.append((end, a))
            total += max(0, b - max(a, end))
            end = max(end, b)
        if hi > end:
            gaps.append((end, hi))
        return total, gaps

    def idle_gaps(self, lo: int, hi: int, n: int = 10) -> List[tuple]:
        """The `n` longest idle gaps of the device in [lo, hi] (`busy`),
        longest first, as (name, ms): the name of the shortest host span
        that covers at least half of the gap, or "between frames"."""
        host = sorted((s.start, s.end, s.name) for s in self.read_spans()
                      if s.end is not None)
        out = []
        for a, b in sorted(self.busy(lo, hi)[1], key=lambda g: g[0] - g[1]
                           )[:n]:
            name, length = "between frames", None
            for ha, hb, hname in host:
                if ha > b:
                    break
                if min(hb, b) - max(ha, a) >= 0.5 * (b - a) and (
                        length is None or hb - ha < length):
                    name, length = hname, hb - ha
            out.append((name, (b - a) / 1e6))
        return out

    def per_frame(self) -> Dict[int, Dict[str, float]]:
        """Per frame index: `host_ms`, its `frame` span; `wait_ms`, its
        `records` spans (the host waiting for the device); `device_ms`,
        the union of its spans' device intervals (0 without any).  Waits
        for the device (`read_spans`)."""
        out: Dict[int, Dict[str, float]] = {}
        dev: Dict[int, list] = defaultdict(list)
        for s in self.read_spans():
            if s.frame is None or s.end is None:
                continue
            row = out.setdefault(s.frame, {"host_ms": 0.0, "wait_ms": 0.0,
                                           "device_ms": 0.0})
            if s.name == "frame":
                row["host_ms"] = (s.end - s.start) / 1e6
            elif s.name == "records":
                row["wait_ms"] += (s.end - s.start) / 1e6
            if s.device is not None:
                dev[s.frame].append(s.device)
        for frame, ivs in dev.items():
            total, end = 0, None
            for a, b in sorted(ivs):
                total += b - a if end is None else max(0, b - max(a, end))
                end = b if end is None else max(end, b)
            out[frame]["device_ms"] = total / 1e6
        return out

    def chrome_trace(self) -> dict:
        """The spans as a Chrome trace (chrome://tracing, Perfetto): the
        host spans on one track and their device intervals on another,
        microseconds from the clock's anchor (or the first span)."""
        spans = [s for s in self.read_spans() if s.end is not None]
        if self._anchor is not None:
            t0 = self._anchor[1]
        else:
            t0 = min((s.start for s in spans), default=0)
        events = [{"ph": "M", "name": "thread_name", "pid": 0, "tid": tid,
                   "args": {"name": name}}
                  for tid, name in ((0, "host spans"),
                                    (1, "device intervals"))]
        for s in spans:
            args = {"id": s.id, "frame": s.frame, "parent": s.parent}
            events.append({"name": s.name, "ph": "X", "pid": 0, "tid": 0,
                           "ts": (s.start - t0) / 1e3,
                           "dur": (s.end - s.start) / 1e3, "args": args})
            if s.device is not None:
                a, b = s.device
                events.append({"name": s.name, "ph": "X", "pid": 0,
                               "tid": 1, "ts": (a - t0) / 1e3,
                               "dur": (b - a) / 1e3, "args": args})
        return {"traceEvents": events, "displayTimeUnit": "ms"}


@contextlib.contextmanager
def trace_if_enabled(tag: str = "livo", env_var: str = "LIVO_TRACE_DIR",
                     timers: Optional[StageTimers] = None):
    """Wrap a region in a torch.profiler trace when `env_var` names a
    directory; the trace is written as `<dir>/<tag>/trace-<ns>.json`
    (chrome://tracing, Perfetto).  With `timers`, spans are turned on for
    the region (if they are not on already, and off again after it) and
    written beside it as `<dir>/<tag>/spans-<ns>.json`
    (`StageTimers.chrome_trace`).  Does nothing when the variable is
    unset."""
    trace_dir = os.environ.get(env_var)
    if not trace_dir:
        yield
        return
    path = os.path.join(trace_dir, tag)
    os.makedirs(path, exist_ok=True)
    started = timers is not None and timers.spans is None
    if started:
        timers.start_spans()
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    ns = time.time_ns()
    prof.export_chrome_trace(os.path.join(path, f"trace-{ns}.json"))
    if timers is not None:
        with open(os.path.join(path, f"spans-{ns}.json"), "w") as f:
            json.dump(timers.chrome_trace(), f)
    if started:
        timers.spans = None
