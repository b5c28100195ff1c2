"""The card's busy time per traced tick: the union of the device's
intervals in the traced window over its ticks, in ms."""

from port_bench.trace import busy_intervals


def read(rec):
    lo, hi = rec["trace"]["window_us"]
    busy = sum(b - a for a, b in busy_intervals(rec["trace"]["device"], lo, hi))
    return busy / 1e3 / rec["trace"]["ticks"] if rec["trace"]["ticks"] and busy > 0 else None
