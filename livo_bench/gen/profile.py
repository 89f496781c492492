"""Device time from a torch.profiler trace: the union of the device's
busy intervals over a host window, the ops that took most device time,
and the longest idle gaps with what the host was doing under them.

Frozen from `chip_smoke.py::device_profile` at commit f22c487785a4 (the
union of device intervals, range annotations left out, top ops by
device time); later changes to the port do not change it.  The gaps are
this benchmark's addition.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

# host calls that hand the device work; not what the host "was doing"
LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
            "cuLaunchKernelEx", "cudaGraphLaunch", "cuGraphLaunch",
            "cudaMemcpyAsync", "cudaMemsetAsync")


def split(events, annotations: str = "livo_bench.") -> tuple:
    """(device [(start_us, end_us, name)], host [(start, end, name)]) of
    `prof.events()`; device annotations of host ranges are left out."""
    from torch.autograd import DeviceType

    dev, host = [], []
    for e in events:
        a, b = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            if not e.name.startswith(annotations):
                dev.append((a, b, e.name))
        elif e.device_type == DeviceType.CPU:
            host.append((a, b, e.name))
    dev.sort()
    host.sort()
    return dev, host


def busy(dev: List[Tuple[float, float, str]], lo: float, hi: float
         ) -> Tuple[float, List[Tuple[float, float]]]:
    """Busy microseconds of the union of device intervals within [lo, hi]
    and the idle gaps between them (and at the window's ends)."""
    total, end, gaps = 0.0, lo, []
    for a, b, _ in dev:
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if a > end:
            gaps.append((end, a))
        total += max(0.0, b - max(a, end))
        end = max(end, b)
    if hi > end:
        gaps.append((end, hi))
    return total, gaps


def top_ops(dev, lo: float, hi: float, n: int = 10) -> List[list]:
    """The `n` device ops with the most device seconds in [lo, hi]."""
    by: Dict[str, float] = {}
    for a, b, name in dev:
        a, b = max(a, lo), min(b, hi)
        if b > a:
            by[name] = by.get(name, 0.0) + (b - a)
    top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
    return [[name[:120], us / 1e6] for name, us in top]


def host_under(host, a: float, b: float) -> str:
    """The host op that covers most of [a, b] (launch calls excepted), or
    "idle host" where none does.  Nested ops: the innermost of those that
    cover at least half of the gap."""
    best, best_len = None, math.inf
    span = b - a
    for ha, hb, name in host:
        if ha > b:
            break
        if name in LAUNCHES:
            continue
        cover = min(hb, b) - max(ha, a)
        if cover >= 0.5 * span and (hb - ha) < best_len:
            best, best_len = name, hb - ha
    return best or "idle host"


def idle_gaps(host, gaps, n: int = 10) -> List[list]:
    """The `n` longest gaps, each named by what the host was doing."""
    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:n]
    return [[host_under(host, a, b)[:120], (b - a) / 1e6]
            for a, b in longest]
