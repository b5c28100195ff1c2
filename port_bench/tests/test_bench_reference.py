"""The plain reference against the port at a small size, and the guards:
the reference imports nothing of the port, and a run loads no JAX."""

import ast
import subprocess
import sys
import types

import pytest
import torch

from port_bench.harness import guarded_modules
from port_bench.reference import fold
from port_bench.reference import stress_soa as ref
from port_bench.worlds import COLUMNS, initial_columns

from conftest import ROOT


def _port_world(seed, world, n):
    from bevy_ggrs_tpu_torch.models import stress_soa
    from bevy_ggrs_tpu_torch.snapshot.world import spawn_many

    app = stress_soa.make_app(n_entities=n, device="cpu")
    w = spawn_many(app.reg, app.reg.init_state(torch.device("cpu")),
                   initial_columns(seed, world, n, "cpu"), count=n)
    return app, w


@pytest.mark.parametrize("seed", [0, 3, 2**31 + 9])
def test_reference_follows_the_port_bit_for_bit(seed):
    from bevy_ggrs_tpu_torch.snapshot.checksum import checksum_to_int, world_checksum

    n, frames = 3000, 120
    app, w = _port_world(seed, 1, n)
    _final, stacked, checks = app.resim_fn(w, torch.zeros((frames, 2), dtype=torch.uint8),
                                           torch.zeros((frames, 2), dtype=torch.int8), 0)
    cols = {k: v[None] for k, v in initial_columns(seed, 1, n, "cpu").items()}
    assert fold.checksums(cols, COLUMNS) == [checksum_to_int(world_checksum(app.reg, w))]
    dt = ref.frame_dt(60)
    for f in range(frames):
        cols = ref.step(cols, dt)
        for k in COLUMNS:
            assert torch.equal(cols[k][0].view(torch.int32),
                               stacked.comps[k][f].view(torch.int32)), (f, k)
        if f % 17 == 0:
            assert fold.checksums(cols, COLUMNS) == [checksum_to_int(checks[f])]
    # the bounce is met: some entity has left [-40, 40)
    assert float(cols["y"].abs().max()) == 50.0


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted((ROOT / "port_bench/reference").glob("*.py"))
                         + [ROOT / "port_bench/worlds.py"], ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    tops = {m.split(".")[0] for m in _imports(path)}
    assert not tops & {"bevy_ggrs_tpu_torch", "bevy_ggrs_tpu", "jax", "jaxlib", "flax"}


def test_the_guard_compares_whole_top_level_names(monkeypatch):
    for name in ("jaxlike", "bevy_ggrs_tpu_torch_extra", "flaxen"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    base = guarded_modules()
    monkeypatch.setitem(sys.modules, "bevy_ggrs_tpu.ops", types.ModuleType("bevy_ggrs_tpu.ops"))
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    assert set(guarded_modules()) - set(base) == {"bevy_ggrs_tpu.ops", "jax"}


def test_a_run_loads_no_jax():
    code = ("import json, sys; from pathlib import Path\n"
            "from port_bench.harness import run_cell, guarded_modules\n"
            "run_cell(Path('.'), 'world32m_synctest_d7', 4, 0.3, False, device='cpu',\n"
            "         overrides={'config': {'entities': 256}, 'traffic': {'warm_ticks': 10}})\n"
            "print(json.dumps(guarded_modules()))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"
