"""iekf.useful_round_pct: the share of the IEKF's rounds that did work in
the LIO step's steady phase: 100 x the rounds whose flag was up (the
program's device count `lio.active_rounds`) over the rounds it counted
(`lio.active_rounds.added()`; a captured step runs every masked round).
Programs captured with stage events on add to both, and the traced run
captures every step program so; the step's init phase is left out.
Both count from the process's start, so the warm-up's steady steps are
in them too.  Nothing where the program has no such count, or no traced
window ran."""

import sys


def read(traced):
    lio = sys.modules.get("sr_livo_tpu_torch.models.lio")
    count = getattr(lio, "active_rounds", None)
    if not traced.timer_calls or count is None:
        return None
    run = count.added()
    return 100.0 * count.read() / run if run else None
