"""One run of one cell: set-up, warm-up, the measured window, the trace,
the comparison with the plain reference, and the result.

Set-up builds the cell's game (``drivers/``) from the seed and plays its
``warm_ticks``: every wave bucket, rollback depth and allocation the game
uses is met there, so nothing is built inside the window.  ``setup_s``
runs from the process's start to the window's.  The window then ticks the
game until ``seconds`` have passed and ends at a device synchronize;
``frames_per_s`` is every world's frames advanced in it over its length,
``tick_ms_p95`` (where the cell reports it) the 95th percentile of all
its ticks on the card's clock: a CUDA event on the compute stream marks
the window's start and the end of each tick's work, and a tick runs from
the previous mark to its own, the time between two frames that a player
sees (the host submits ticks ahead of the card, so its own clock times
the submission; the work line gives both).  With ``trace`` the window's
first ticks run under the profiler (``trace.py``) and the per-layer
readers (``metrics/``) read them.  Once the window has closed and the
peak memory is read, the program's outputs are compared with the plain
reference (``reference/compare.py``) and the program is freed first.
"""

from __future__ import annotations

import gc
import os
import sys
import time
from pathlib import Path

import numpy as np

from . import spec
from .drivers.common import WORK_KEYS
from .worlds import COLUMNS

#: top-level module names no run may load (compared whole)
GUARDED = ("jax", "jaxlib", "flax", "bevy_ggrs_tpu")

#: the compared numbers' limits (PERF.md section 2 gives their readings)
LIMITS = {"state_gap": 0.0, "checksum_mismatches": 0, "unjudged_worlds": 0, "desyncs": 0}

_T_IMPORT = time.perf_counter()


class NoDevice(RuntimeError):
    """The card the cell needs is not there."""


def process_seconds() -> float:
    """Seconds since this process started."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        elapsed = time.clock_gettime(time.CLOCK_BOOTTIME) - start
        if 0.0 < elapsed < 86400.0:
            return elapsed
    except (OSError, ValueError, IndexError):
        pass
    return time.perf_counter() - _T_IMPORT


def guarded_modules() -> list:
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in GUARDED)


def cuda_device(chips: int):
    import torch

    if not torch.cuda.is_available():
        raise NoDevice("no CUDA device: torch.cuda.is_available() is false")
    if torch.cuda.device_count() < chips:
        raise NoDevice(f"the cell needs {chips} cards, {torch.cuda.device_count()} found")
    return torch.device("cuda", 0)


def run_cell(root, workload: str, seed: int, seconds: float, trace: bool,
             device=None, overrides: dict | None = None) -> dict:
    """One run; returns the result (``line``), the work line (``work``)
    and the compared numbers (``checks``).  ``device`` None takes the
    card; a test passes ``"cpu"`` and ``overrides`` (``config`` and
    ``traffic`` keys) to run it small."""
    import torch

    cell = spec.cell(Path(root), workload)
    overrides = overrides or {}
    config = {**cell["config"], **overrides.get("config", {})}
    traffic = {**cell["traffic"], **overrides.get("traffic", {})}
    chips = int(cell["entry"]["chips"])
    dev = cuda_device(chips) if device is None else torch.device(device)
    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    marks = {"started": process_seconds()}
    game = spec.driver(traffic["driver"]).build(config, traffic, seed, dev)
    try:
        sync()
        marks["built"] = process_seconds()
        for _ in range(int(traffic["warm_ticks"])):
            game.tick()
        sync()

        starts, ends, blocks = [], [], []
        c0, p0 = game.counters(), game.phase_seconds()

        def timed_tick():
            if len(starts) % 100 == 0:
                blocks.append(game.counters())
            starts.append(time.perf_counter())
            game.tick()
            if on_card:
                ends.append(_device_mark(dev))

        tracer = None
        # set-up's objects leave the collector's generations: the window's
        # collections then walk only what the window made
        gc.collect()
        gc.freeze()
        setup_s = process_seconds()
        t0 = time.perf_counter()
        begin = _device_mark(dev) if on_card else None
        if trace:
            from .trace import Tracer

            tracer = Tracer(int(traffic["trace_ticks"]))
            tracer.run(timed_tick, sync, game.counters)
        while time.perf_counter() - t0 < seconds:
            timed_tick()
        sync()
        t_end = time.perf_counter()
        c1, p1 = game.counters(), game.phase_seconds()
        if len(starts) % 100 == 0:
            blocks.append(c1)
        ticks = len(starts)
        window_s = t_end - t0
        # every tick of the window on the host clock, from its start to the
        # next one's (the last to the synchronize), and on the card's
        host_ms = np.diff(np.asarray(starts + [t_end])) * 1e3
        durations_ms = (np.diff(np.asarray([0.0] + [begin.elapsed_time(e) for e in ends]))
                        if on_card else host_ms)
        peak = torch.cuda.max_memory_allocated(dev) if on_card else 0

        # the program's outputs; the program is freed before the reference
        states, checks = game.outputs()
        unjudged = sum(1 for seen in game.seen if not seen)
        desyncs = game.desyncs
        worlds = len(game.rings())
    finally:
        game.close()
        gc.unfreeze()
    del game
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    from .reference.compare import compare

    t_ref = time.perf_counter()
    readings = compare(states, checks, seed, int(config["entities"]), int(config["fps"]), dev)
    reference_s = time.perf_counter() - t_ref
    del states
    values = {"state_gap": readings["state_gap"],
              "checksum_mismatches": readings["checksum_mismatches"],
              "unjudged_worlds": unjudged, "desyncs": desyncs}
    compared = {k: {"value": v, "limit": LIMITS[k]} for k, v in values.items()}
    correct = all(v <= LIMITS[k] for k, v in values.items())

    quantiles = ("p50", "p90", "p95", "p99", "max")
    work = {"setup_marks_s": {**marks, "warmed": setup_s}, "work_keys": list(WORK_KEYS),
            "ticks": ticks,
            "work_per_100_ticks": [[b[k] - a[k] for k in WORK_KEYS]
                                   for a, b in zip(blocks, blocks[1:])],
            "window": {k: c1[k] - c0[k] for k in WORK_KEYS},
            "tick_ms_quantiles": dict(zip(quantiles, np.percentile(
                durations_ms, [50, 90, 95, 99, 100]).tolist())),
            "host_tick_ms_quantiles": dict(zip(quantiles, np.percentile(
                host_ms, [50, 90, 95, 99, 100]).tolist())),
            "ticks_over_1.25_median": int(np.sum(durations_ms > 1.25 * np.median(durations_ms))),
            "reference_s": reference_s,
            "states_compared": readings["states_compared"],
            "checksums_compared": readings["checksums_compared"]}
    device_info = {"platform": "gpu" if on_card else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if on_card else dev.type,
                   "count": chips, "memory_peak_bytes": int(peak)}
    line = {"correct": bool(correct), "attempted": ticks * worlds,
            "failed": (c1["stalls"] - c0["stalls"]) + desyncs}
    if trace:
        rec = trace_record(tracer, config, ticks, {k: p1.get(k, 0.0) - p0.get(k, 0.0) for k in p1},
                           on_card)
        metrics = {}
        for m in cell["per_layer"]:
            value = spec.reader(m["name"]).read(rec)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        from .trace import breakdown, busy_intervals

        lo, hi = rec["trace"]["window_us"]
        device_info["busy_s"] = sum(b - a for a, b in busy_intervals(rec["trace"]["device"],
                                                                      lo, hi)) / 1e6
        device_info["window_s"] = (hi - lo) / 1e6
        line.update(metrics=metrics, device=device_info, breakdown=breakdown(rec["trace"]))
    else:
        frames = c1["frames"] - c0["frames"]
        metrics = {"frames_per_s": frames / window_s,
                   "tick_ms_p95": float(np.percentile(durations_ms, 95)),
                   "setup_s": setup_s}
        units = {m["name"]: m["unit"] for m in cell["end_to_end"]}
        line.update(metrics={k: {"value": v, "unit": units[k]} for k, v in metrics.items()
                             if k in units}, device=device_info)
    line["checks"] = compared
    return {"line": line, "work": work, "checks": compared}


def _device_mark(dev):
    """A timing event recorded on ``dev``'s current stream: it completes
    once the work submitted before it has run."""
    import torch

    event = torch.cuda.Event(enable_timing=True)
    event.record(torch.cuda.current_stream(dev))
    return event


def trace_record(tracer, config: dict, window_ticks: int, phase_seconds: dict,
                 on_card: bool) -> dict:
    """What the per-layer readers read (``metrics/__init__.py``)."""
    from .roofline import sm_clocks_per_s

    before, after = tracer.counts
    return {"trace": tracer.record(), "window_ticks": window_ticks,
            "phase_seconds": phase_seconds,
            "trace_frames": after["frames"] - before["frames"],
            "trace_simulated_frames": after["simulated_frames"] - before["simulated_frames"],
            "entities": int(config["entities"]), "component_lanes": [1] * len(COLUMNS),
            "sm_clocks_per_s": sm_clocks_per_s() if on_card else float("nan")}
