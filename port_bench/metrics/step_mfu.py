"""The whole frame's share of the card's peak: the least time the traced
ticks' frames need (each simulated world-frame's step bytes and its
checksum pass, ``port_bench/roofline.py``) over the traced window, in
percent.  Simulated frames are those advanced and those resimulated."""

from port_bench.roofline import STEP_BYTES_PER_ENTITY, fold_work, least_seconds


def read(rec):
    frames, n = rec["trace_simulated_frames"], rec["entities"]
    lo, hi = rec["trace"]["window_us"]
    if not frames or hi <= lo or not rec["trace"]["device"]:
        return None
    work = fold_work(frames, n, rec["component_lanes"])
    work["bytes"] += frames * n * STEP_BYTES_PER_ENTITY
    return 100.0 * least_seconds(work, rec["sm_clocks_per_s"]) / ((hi - lo) / 1e6)
