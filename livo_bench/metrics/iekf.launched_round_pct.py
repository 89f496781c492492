"""iekf.launched_round_pct: the share of the IEKF's rounds that the LIO
step's steady phase launched on the device: 100 x the rounds launched (the
program's device count `lio.launched_rounds`, added at the start of every
round that runs) over the rounds its bound allows (`lio.active_rounds.
added()`, the denominator of `iekf.useful_round_pct`).  Masked rounds
launch every round (100); a WHILE node only the live ones.  Programs
captured with stage events on add to both, and the traced run captures
every step program so; the step's init phase is left out.  Nothing where
the program has no such count, or no traced window ran."""

import sys


def read(traced):
    lio = sys.modules.get("sr_livo_tpu_torch.models.lio")
    launched = getattr(lio, "launched_rounds", None)
    bound = getattr(lio, "active_rounds", None)
    if not traced.timer_calls or launched is None or bound is None:
        return None
    run = bound.added()
    return 100.0 * launched.read() / run if run else None
