"""Per-stage wall-clock timers (port of `sr_livo_tpu/utils/profiling.py`).

PyTorch launches CUDA work asynchronously, so a host clock stopped right
after a stage measures only its enqueue.  A stage that launches device
work calls `synchronize()` before it ends: with `sync=True` (on a CUDA
device) that is `torch.cuda.synchronize()`, so the stage time includes
its device work; otherwise it does nothing.
"""

from __future__ import annotations

import contextlib
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
            self.total[name] += time.perf_counter() - t0
            self.count[name] += 1

    def report(self) -> Dict[str, Dict[str, float]]:
        return {
            name: {
                "total_s": self.total[name],
                "count": self.count[name],
                "mean_ms": 1000.0 * self.total[name] / max(self.count[name], 1),
            }
            for name in sorted(self.total)
        }

    def summary(self) -> str:
        lines = ["stage                    count   mean ms   total s"]
        for name, r in self.report().items():
            lines.append(f"{name:<24} {r['count']:>5} {r['mean_ms']:>9.2f} "
                         f"{r['total_s']:>9.2f}")
        return "\n".join(lines)
