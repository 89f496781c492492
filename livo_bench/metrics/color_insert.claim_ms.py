"""color_insert.claim_ms: device ms of the colored-map insert's dedup claim
rounds, per insert: the range `claim` (from its `graphs.mark` to the next,
`write`) in each replay of the program named `color_insert`, from the
program's log of its replays (`graphs.stage_log()`, read once each
replay's events completed, never with a wait).  Every sweep replays it
once: alone on a sweep without an image (stage `color_insert`), inside
the vision frame on a rendered one (stage `vis_insert`).  The window's
replays are the log's last, as many as the window's calls of those two
stages.  Nothing where the program keeps no such log or its graph holds
no such range (the CPU, or a program without the insert's marks)."""

import sys

STAGES = ("color_insert", "vis_insert")


def read(traced):
    graphs = sys.modules.get("sr_livo_tpu_torch.utils.graphs")
    stage_log = getattr(graphs, "stage_log", None)
    n = sum(1 for f, name, _ in traced.timer_calls
            if name in STAGES and f >= 0)
    if stage_log is None or not n:
        return None
    ms = [d["claim"] for name, d in stage_log()
          if name == "color_insert" and "claim" in d][-n:]
    return sum(ms) / len(ms) if ms else None
