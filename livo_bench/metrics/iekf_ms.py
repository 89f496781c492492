"""iekf_ms: device ms of the IEKF inside the LIO step's graph, per sweep:
the span between the events `graphs.mark` records at the `iekf` and
`insert` stages, over every LIO step replay of the traced window (the
harness takes them from `graphs.stage_log()`: a frame with a gap-fill
sweep replays the step more than once)."""

from livo_bench.metrics._stages import mean


def read(traced):
    return mean([s["iekf"] for s in traced.step_stages if "iekf" in s])
