"""Host ms per tick submitting device work: the runners' phase timer
``wave_dispatch`` (the resim's or the wave's submission, not its
execution), summed over the runners, over the whole window."""


def read(rec):
    s = rec["phase_seconds"].get("wave_dispatch", 0.0)
    return s / rec["window_ticks"] * 1e3 if rec["window_ticks"] and s > 0 else None
