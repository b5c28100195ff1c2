"""Each per-layer reader on a small recorded trace, with the values worked
out by hand, and each reader's silence where there is nothing to read."""

import copy

import pytest

from port_bench import spec
from port_bench.trace import breakdown

from conftest import ROOT

CLOCKS = 132 * 1980e6  # SMs x max SM clock of an H100 SXM

# four traced ticks of 1,000 microseconds: kernels, a copy, two spans
REC = {
    "trace": {
        "window_us": [0.0, 1000.0], "ticks": 4,
        "device": [["elementwise_kernel", "kernel", 0.0, 100.0],
                   ["void (anonymous namespace)::fold_kernel<true>(Params)", "kernel", 150.0, 250.0],
                   ["void (anonymous namespace)::finalize_kernel(Params)", "kernel", 250.0, 260.0],
                   ["Memcpy DtoD (Device -> Device)", "copy", 240.0, 300.0],
                   ["where_kernel", "kernel", 900.0, 1100.0]],
        "spans": [["AdvanceWorld", 0.0, 500.0], ["SaveWorld", 500.0, 650.0]],
        "fold_calls": [[2, 1000, [1, 1, 1, 1, 1, 1]]],
    },
    "window_ticks": 10,
    "phase_seconds": {"net_poll": 0.002, "session_step": 0.003, "wave_dispatch": 0.05},
    "trace_frames": 8, "trace_simulated_frames": 16, "entities": 1000,
    "component_lanes": [1] * 6, "sm_clocks_per_s": CLOCKS,
}

# the fold's work on [2, 1000] x 6 float columns, counted by hand from
# chip_smoke.py's fold_bound (every row live and kept)
ROWS = 2000
FOLD_BYTES = ROWS + ROWS + 2 * 4 + 2 * 7 * 2 * 8 + 6 * (ROWS + ROWS * 4) + ROWS * 4
FOLD_ALU = 2 * ROWS + 2 * 2 * (8 * 6 + 13) + 6 * (ROWS + ROWS * 33) + ROWS
FOLD_FMA = 2 * 2 * (2 * 6 + 8) + 6 * ROWS * 16 + 2 * ROWS


def _least(nbytes, alu, fma):
    return max(nbytes / 3.35e12, alu / (64 * CLOCKS), fma / (64 * CLOCKS),
               (alu + fma) / (128 * CLOCKS))


EXPECTED = {
    "session_ms_per_tick": 0.5,
    "dispatch_ms_per_tick": 5.0,
    "launches_per_frame": 4 / 8,
    # busy: [0, 100] + [150, 300] + [900, 1000] = 350 of 1000 us
    "device_idle_pct": 65.0,
    "device_ms_per_tick": 0.350 / 4,
    "fold_roofline": 100 * _least(FOLD_BYTES, FOLD_ALU, FOLD_FMA) / 110e-6,
}


def _step_mfu():
    rows = 16 * 1000
    nbytes = (rows + rows + 16 * 4 + 16 * 7 * 2 * 8 + 6 * (rows + rows * 4) + rows * 4
              + rows * 50)
    alu = 2 * rows + 16 * 2 * (8 * 6 + 13) + 6 * (rows + rows * 33) + rows
    fma = 16 * 2 * (2 * 6 + 8) + 6 * rows * 16 + 2 * rows
    return 100 * _least(nbytes, alu, fma) / 1e-3


EXPECTED["step_mfu"] = _step_mfu()


def _names():
    return [m["name"] for m in spec.benchmark(ROOT)["per_layer"]]


def test_every_metric_has_a_reader_and_a_hand_value():
    assert sorted(_names()) == sorted(EXPECTED)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_reads_the_recorded_trace(name):
    assert spec.reader(name).read(copy.deepcopy(REC)) == pytest.approx(EXPECTED[name], rel=1e-9)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_with_nothing_to_read_is_silent(name):
    empty = copy.deepcopy(REC)
    empty["trace"]["device"] = []
    empty["trace"]["fold_calls"] = []
    empty["phase_seconds"] = {}
    empty["trace_frames"] = 0
    assert spec.reader(name).read(empty) is None


def test_breakdown_names_the_gaps_by_the_span_running():
    b = breakdown(REC["trace"])
    assert b["idle_gaps"] == [["SaveWorld", pytest.approx(600e-6)],
                              ["AdvanceWorld", pytest.approx(50e-6)]]
    ops = dict(b["device_ops"])
    assert ops["where_kernel"] == pytest.approx(100e-6)  # clipped to the window
    assert ops["Memcpy DtoD (Device -> Device)"] == pytest.approx(60e-6)
    assert b["device_ops"][-1][0] == "void (anonymous namespace)::finalize_kernel(Params)"
