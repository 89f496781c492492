"""Per-stage wall-clock timers and the trace context (port of
`sr_livo_tpu/utils/profiling.py`).

PyTorch launches CUDA work asynchronously, so a host clock stopped right
after a stage measures only its enqueue.  A stage that launches device
work calls `synchronize()` before it ends: with `sync=True` (on a CUDA
device) that is `torch.cuda.synchronize()`, so the stage time includes
its device work; otherwise it does nothing.

`trace_if_enabled` captures a `torch.profiler` trace of a region (host
ops, and the device's kernels where CUDA is available) as a Chrome trace
under `$LIVO_TRACE_DIR/<tag>/` when that variable is set.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict

import torch


class StageTimers:
    """Accumulates wall-clock per named stage; thread-unsafe by design
    (one per pipeline)."""

    def __init__(self, sync: bool = False, device="cpu"):
        self.sync = sync
        self.device = torch.device(device)
        self.total: Dict[str, float] = defaultdict(float)
        self.count: Dict[str, int] = defaultdict(int)
        self.longest: Dict[str, float] = defaultdict(float)

    def synchronize(self):
        """Wait for the device when `sync` is on (call inside a stage)."""
        if self.sync and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.total[name] += dt
            self.count[name] += 1
            self.longest[name] = max(self.longest[name], dt)

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


@contextlib.contextmanager
def trace_if_enabled(tag: str = "livo", env_var: str = "LIVO_TRACE_DIR"):
    """Wrap a region in a torch.profiler trace when `env_var` names a
    directory; the trace is written as `<dir>/<tag>/trace-<ns>.json`
    (chrome://tracing, Perfetto).  Does nothing when it is unset."""
    trace_dir = os.environ.get(env_var)
    if not trace_dir:
        yield
        return
    path = os.path.join(trace_dir, tag)
    os.makedirs(path, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(
        os.path.join(path, f"trace-{time.time_ns()}.json"))
