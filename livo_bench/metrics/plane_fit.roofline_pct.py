"""plane_fit.roofline_pct: the plane kernel's share of its roofline in the
LIO step: over the sampled frames' step calls, the least time of each
launch the trace shows (`gen/roofline.py`, paired by entry within its
call, `harness.pair_roofline`) over the launches' own device time."""


def read(traced):
    if not traced.roofline:
        return None
    bound = sum(b for b, _ in traced.roofline)
    spent = sum(k for _, k in traced.roofline)
    return 100.0 * bound / spent if spent > 0 else None
