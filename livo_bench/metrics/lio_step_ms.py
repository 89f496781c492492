"""lio_step_ms: the LIO step program's call, per sweep, to the end of its
device work (stage `lio_step` of the synchronizing timers)."""

from livo_bench.metrics._stages import mean, per_call_ms


def read(traced):
    return mean(per_call_ms(traced, "lio_step"))
