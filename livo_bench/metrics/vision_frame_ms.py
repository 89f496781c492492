"""vision_frame_ms: a rendered frame's vision work to the end of its
device work, per rendered frame: the colored-map insert and the frame
program (preprocess, pyramid, LK, RANSAC, the ESIKFs, rendering, track
upkeep), stage `vision_frame`."""

from livo_bench.metrics._stages import mean, per_call_ms


def read(traced):
    return mean(per_call_ms(traced, "vision_frame"))
