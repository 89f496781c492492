"""host_prep_ms: the host's preparation of a frame, per frame: the sweep's
window, decimation and int16 wire pack (`prepare_sweep`) and the image's
dtype, scale and remap (`vis_host_prep`), pipeline stage timers."""

from livo_bench.metrics._stages import mean, per_frame_ms


def read(traced):
    return mean(per_frame_ms(traced, ("prepare_sweep", "vis_host_prep")))
