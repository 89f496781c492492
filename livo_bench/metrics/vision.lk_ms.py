"""vision.lk_ms: device ms of LK tracking in the vision frame program's
graph, per rendered frame of the traced window: the range `lk` (from its
`graphs.mark` to the next) in each replay of a program named
`vision_frame[...]`, from the program's log of its replays
(`graphs.stage_log()`, read once each replay's events completed, never
with a wait).  The window's replays are the log's last, as many as the
window's `replay` stages.  Nothing where the program keeps no such log
or its graphs hold no marks (the CPU)."""

import sys


def read(traced):
    graphs = sys.modules.get("sr_livo_tpu_torch.utils.graphs")
    stage_log = getattr(graphs, "stage_log", None)
    n = sum(1 for f, name, _ in traced.timer_calls
            if name == "replay" and f >= 0)
    if stage_log is None or not n:
        return None
    ms = [d["lk"] for name, d in stage_log()
          if name.startswith("vision_frame") and "lk" in d][-n:]
    return sum(ms) / len(ms) if ms else None
