"""Kernels per frame advanced: the profiler's kernel events in the traced
ticks over the frames those ticks advanced, summed over the game's
worlds (copies and fills are not kernels)."""


def read(rec):
    kernels = sum(1 for d in rec["trace"]["device"] if d[1] == "kernel")
    return kernels / rec["trace_frames"] if rec["trace_frames"] and kernels else None
