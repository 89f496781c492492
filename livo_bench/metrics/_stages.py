"""Shared arithmetic of the stage-time readers: the traced run's timer
calls, (frame, stage, seconds), with the pipeline's timers synchronizing
at the end of every stage."""


def per_call_ms(traced, stage: str) -> list:
    return [1e3 * s for (_f, name, s) in traced.timer_calls if name == stage]


def per_frame_ms(traced, stages) -> list:
    """Per frame, the summed ms of `stages` (frames with none left out)."""
    by = {}
    for f, name, s in traced.timer_calls:
        if name in stages:
            by[f] = by.get(f, 0.0) + 1e3 * s
    return list(by.values())


def mean(values):
    return sum(values) / len(values) if values else None
