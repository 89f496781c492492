"""device.idle_pct: the share of the traced window in which no operation
ran on the card (`gen/profile.py`: the union of the device intervals)."""


def read(traced):
    if not traced.window_s:
        return None
    return 100.0 * (1.0 - traced.busy_s / traced.window_s)
