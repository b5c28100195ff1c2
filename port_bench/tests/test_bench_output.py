"""The run's output: the work line and the one-line result parse, with
the contract's keys, and a run without a card prints no result."""

import json
import os

import pytest

from port_bench import run, spec
from port_bench.harness import run_cell

from conftest import CELLS, tiny


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_the_result_line_parses(root, workload, trace):
    out = run_cell(root, workload, 2**31 + 5, 0.5, trace, device="cpu",
                   overrides=tiny(workload))
    line = json.loads(json.dumps(out["line"]))
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert line["correct"] is True
    assert line["attempted"] > 0 and line["failed"] == 0
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(line["device"])
    assert all(set(c) == {"value", "limit"} for c in line["checks"].values())
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        # no card: the device-trace readers find nothing and stay out of the line
        assert set(line["metrics"]) <= {"session_ms_per_tick", "dispatch_ms_per_tick"}
    else:
        # the cell's own end-to-end metrics, as BENCHMARK.json lists them
        wanted = {m["name"] for m in spec.cell(root, workload)["end_to_end"]}
        assert "setup_s" in wanted and len(wanted) >= 2
        assert set(line["metrics"]) == wanted
        assert all(m["value"] > 0 for m in line["metrics"].values())
    work = json.loads(json.dumps(out["work"]))
    assert work["states_compared"] > 0 and work["checksums_compared"] > 0


def test_no_card_no_result(monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("TORCH_EXTENSIONS_DIR", os.environ.get("TORCH_EXTENSIONS_DIR", ""))
    monkeypatch.setenv("TRITON_CACHE_DIR", os.environ.get("TRITON_CACHE_DIR", ""))
    rc = run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1", "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""
