"""color_insert_ms: the colored-map insert that runs alone, per call: the
insert program of a sweep without an image (a gap-fill sweep), to the end
of its device work (stage `color_insert` of the synchronizing timers), over
the traced window's calls.  A rendered sweep's insert runs inside the
vision frame (stage `vis_insert`) and is not counted.  Nothing where the
window cut no sweep without an image."""

from livo_bench.metrics._stages import mean


def read(traced):
    return mean([1e3 * s for f, name, s in traced.timer_calls
                 if name == "color_insert" and f >= 0])
