"""The share of the traced window in which no kernel, copy or fill ran
on the card (the union of the device's intervals), in percent."""

from port_bench.trace import busy_intervals


def read(rec):
    lo, hi = rec["trace"]["window_us"]
    busy = sum(b - a for a, b in busy_intervals(rec["trace"]["device"], lo, hi))
    return 100.0 * (1.0 - busy / (hi - lo)) if hi > lo and busy > 0 else None
