"""The cell's files, found by the names in ``BENCHMARK.json``."""

from __future__ import annotations

import importlib
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path) -> dict:
    return load_json(Path(root) / "BENCHMARK.json")


def cell(root: Path, workload: str) -> dict:
    """The cell ``workload``: its entry, configuration, traffic, and the
    per-layer metrics it reports (those that list it, or list no cell)."""
    bench = benchmark(root)
    entry = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    config = next(c for c in bench["configs"] if c["name"] == entry["config"])
    end_to_end = [m for m in bench["end_to_end"]
                  if "workloads" not in m or workload in m["workloads"]]
    reported = {m["name"] for m in end_to_end}
    per_layer = [m for m in bench["per_layer"]
                 if (workload in m["workloads"] if "workloads" in m
                     else m["moves"] in reported)]
    return {"entry": entry,
            "config": load_json(Path(root) / config["file"]),
            "traffic": load_json(HERE / "traffic" / f"{entry['traffic']}.json"),
            "end_to_end": end_to_end,
            "per_layer": per_layer}


def driver(name: str):
    return importlib.import_module(f"port_bench.drivers.{name}")


def reader(name: str):
    return importlib.import_module(f"port_bench.metrics.{name}")
