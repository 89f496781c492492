"""iekf_ms: device ms of the IEKF inside the LIO step's graph, per sweep:
the span between the events `graphs.mark` records at the `iekf` and
`insert` stages (`Program.stage_ms`), read after each replay."""

from livo_bench.metrics._stages import mean


def read(traced):
    return mean([s["iekf"] for s in traced.step_stages if "iekf" in s])
