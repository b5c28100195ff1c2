"""The traced part of a ``--trace 1`` run: a ``torch.profiler`` window of
ticks, the program's spans, and the checksum pass's calls.

The window is ``trace_ticks`` ticks behind one traced and discarded tick
(a profiler window loses kernel records at its start; PERF.md, section 6).  The
last traced tick ends at a device synchronize, so every kernel of the
window has run inside it.  The program's spans (``utils/tracing.span``,
which record nothing unless a sink is installed) are collected on the
host clock and placed on the profiler's clock through the tick markers.
Each call of the checksum pass records the shape of its stack, from which
``metrics/fold_roofline.py`` works out the pass's bound.
"""

from __future__ import annotations

import statistics
import time

import torch

TICK_MARK = "port_bench.tick"
OUTSIDE = "outside_the_program_s_spans"


class Tracer:
    """Profiles ``ticks`` calls of ``tick`` (see the module docstring)."""

    def __init__(self, ticks: int):
        self.ticks = int(ticks)
        self.spans = []  # (name, t0, t1) on the host clock, seconds
        self.marks = []  # host clock at each counted tick's start
        self.fold_calls = []  # (k, n, [lanes per component])
        self.counts = None
        self.prof = None

    def run(self, tick, sync, count) -> None:
        """Run ``ticks + 1`` calls of ``tick`` (the first traced and
        discarded); ``count()`` is read after that one and after the last,
        into :attr:`counts`."""
        from torch.profiler import ProfilerActivity, profile, record_function, schedule

        from bevy_ggrs_tpu_torch.snapshot import checksum as cs
        from bevy_ggrs_tpu_torch.utils import tracing

        fold = cs.checksum_fold

        def recorded(lanes, has, ids, *rest):
            self.fold_calls.append((int(ids.shape[0]), int(ids.shape[1]),
                                    [int(x.shape[2]) for x in lanes]))
            return fold(lanes, has, ids, *rest)

        tracing.set_span_sink(lambda name, t0, t1: self.spans.append((name, t0, t1)))
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        try:
            with profile(activities=activities,
                         schedule=schedule(wait=0, warmup=1, active=self.ticks,
                                           repeat=1)) as prof:
                tick()
                sync()
                prof.step()
                self.spans.clear()
                before = count()
                cs.checksum_fold = recorded
                for i in range(self.ticks):
                    with record_function(TICK_MARK):
                        self.marks.append(time.perf_counter())
                        tick()
                        if i == self.ticks - 1:
                            sync()
                    prof.step()
                self.counts = (before, count())
        finally:
            cs.checksum_fold = fold
            tracing.set_span_sink(None)
        self.prof = prof

    def record(self) -> dict:
        """The traced window as plain data: device events, spans and
        markers on the profiler's clock (microseconds), and the fold's
        calls."""
        marks, device = [], []
        for e in self.prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                if getattr(e, "is_user_annotation", False) or e.name.startswith("ProfilerStep"):
                    continue
                kind = ("copy" if "Memcpy" in e.name else
                        "fill" if "Memset" in e.name else "kernel")
                device.append([e.name, kind, e.time_range.start, e.time_range.end])
            elif e.name == TICK_MARK:
                marks.append([e.time_range.start, e.time_range.end])
        marks.sort()
        # host clock -> profiler clock, from the tick markers
        offset = statistics.median(m[0] - h * 1e6 for m, h in zip(marks, self.marks))
        spans = [[name, t0 * 1e6 + offset, t1 * 1e6 + offset] for name, t0, t1 in self.spans]
        return {"window_us": [marks[0][0], marks[-1][1]], "ticks": len(marks),
                "device": device, "spans": spans, "fold_calls": self.fold_calls}


def busy_intervals(device, lo: float, hi: float) -> list:
    """The union of the device events' intervals, clipped to [lo, hi]."""
    out = []
    for _name, _kind, a, b in sorted(device, key=lambda d: d[2]):
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def breakdown(rec: dict, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle
    gaps summed by the innermost program span running at their middle."""
    lo, hi = rec["window_us"]
    ops: dict = {}
    for name, _kind, a, b in rec["device"]:
        ops[name[:120]] = ops.get(name[:120], 0.0) + (min(b, hi) - max(a, lo)) / 1e6
    busy = busy_intervals(rec["device"], lo, hi)
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    spans = sorted(rec["spans"], key=lambda s: s[2] - s[1])
    gaps: dict = {}
    for a, b in zip(edges[::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) / 2
        name = next((s[0] for s in spans if s[1] <= mid <= s[2]), OUTSIDE)
        gaps[name] = gaps.get(name, 0.0) + (b - a) / 1e6
    order = lambda d: sorted(([k, v] for k, v in d.items() if v > 0),  # noqa: E731
                             key=lambda kv: -kv[1])[:top]
    return {"device_ops": order(ops), "idle_gaps": order(gaps)}
