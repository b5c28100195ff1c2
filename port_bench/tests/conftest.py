"""Shared settings of the benchmark's CPU tests: cells run small on the
CPU, with no look for a card (``run_cell(device="cpu")``)."""

from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
CELLS = ("server16x4m_rb", "world32m_synctest_d7")


def tiny(workload: str, **config) -> dict:
    """Overrides that run ``workload`` small: 512 entities, two matches
    for the server, a short trace, and a warm-up long enough that sampled
    checksums are confirmed before the window (a loaded host may tick
    only a few times in a short window)."""
    cfg = {"entities": 512, **config}
    if workload.startswith("server"):
        cfg.setdefault("matches", 2)
    return {"config": cfg, "traffic": {"warm_ticks": 40, "trace_ticks": 3}}


@pytest.fixture
def root() -> Path:
    return ROOT
