"""plane_fit.roofline_pct: the plane kernel's share of its roofline in the
LIO step: over sampled launches, the least time their inputs need
(`gen/roofline.py`) over the launches' own device time in the trace."""


def read(traced):
    if not traced.roofline:
        return None
    bound = sum(b for b, _ in traced.roofline)
    spent = sum(k for _, k in traced.roofline)
    return 100.0 * bound / spent if spent > 0 else None
