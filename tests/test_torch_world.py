"""The PyTorch port's world against the JAX package's, leaf for leaf.

The same spawn / despawn / insert / remove calls, with inputs drawn from
``numpy.random.default_rng``, go through both packages; every leaf of the
two worlds must then be equal as numpy, exactly (dtype, shape and bits).
The port runs on the CPU (``device="cpu"``).  Also: the port imports
neither JAX nor the JAX package, and its entry points refuse to fall back
to the CPU when no card is present."""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bevy_ggrs_tpu.snapshot.world as jw
import bevy_ggrs_tpu_torch.snapshot.world as tw
from bevy_ggrs_tpu.models import box_game as j_box_game
from bevy_ggrs_tpu.models import fixed_point as j_fixed_point
from bevy_ggrs_tpu.models import stress_soa as j_stress_soa
from bevy_ggrs_tpu_torch import App, GgrsRunner, SessionBuilder
from bevy_ggrs_tpu_torch.convert import world_from_numpy, world_to_numpy
from bevy_ggrs_tpu_torch.models import box_game as t_box_game
from bevy_ggrs_tpu_torch.models import fixed_point as t_fixed_point
from bevy_ggrs_tpu_torch.models import stress_soa as t_stress_soa
from bevy_ggrs_tpu_torch.utils.device import resolve_device

ROOT = Path(__file__).resolve().parents[1]
CAP = 16


def jax_leaves(w) -> dict:
    """A JAX world as ``{field: numpy leaves}``."""
    return {f.name: jax.tree.map(np.asarray, getattr(w, f.name))
            for f in dataclasses.fields(w)}


def _bits(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a).reshape(-1).view(np.uint8)


def assert_worlds_equal(jax_world, torch_world):
    want = jax_leaves(jax_world)
    got = world_to_numpy(torch_world)
    assert set(want) == set(got)
    for field in want:
        wl = jax.tree_util.tree_flatten_with_path(want[field])[0]
        gl = jax.tree_util.tree_flatten_with_path(got[field])[0]
        assert [p for p, _ in wl] == [p for p, _ in gl], field
        for (path, a), (_, b) in zip(wl, gl):
            assert a.dtype == b.dtype, (field, path, a.dtype, b.dtype)
            assert a.shape == b.shape, (field, path)
            assert np.array_equal(_bits(a), _bits(b)), (field, path, a, b)


def make_regs():
    """One registry per package: int32 and f32 columns of several shapes,
    a required component, and checksummed resources."""
    regs = (jw.Registry(CAP), tw.Registry(CAP))
    for reg, i32, f32 in ((regs[0], jnp.int32, jnp.float32),
                          (regs[1], torch.int32, torch.float32)):
        reg.register_component("pos", (2,), f32, checksum=True)
        reg.register_component("hp", (), i32, default=np.int32(100), required=True)
        reg.register_component("tag", (3,), i32, checksum=True)
        reg.register_resource("score", np.int32(0), checksum=True)
        reg.register_resource("wind", {"dir": np.float32(1.5), "gust": np.int32(2)},
                              present=False)
    return regs


@pytest.mark.parametrize("model", ["fixed_point", "box_game", "stress_soa"])
def test_model_init_state_leaves_equal(model):
    kw = {"n_entities": 300} if model == "stress_soa" else {}
    j_mod = {"fixed_point": j_fixed_point, "box_game": j_box_game,
             "stress_soa": j_stress_soa}[model]
    t_mod = {"fixed_point": t_fixed_point, "box_game": t_box_game,
             "stress_soa": t_stress_soa}[model]
    assert_worlds_equal(j_mod.make_app(**kw).init_state(),
                        t_mod.make_app(**kw, device="cpu").init_state())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_op_script_leaves_equal(seed):
    """A seeded script of every world op, compared after each step; it
    covers slot reuse after despawn_confirmed retirement and overflow."""
    jreg, treg = make_regs()
    a, b = jreg.init_state(), treg.init_state("cpu")
    rng = np.random.default_rng(seed)
    frame = 0
    for _ in range(40):
        frame += 1
        op = rng.integers(0, 8)
        if op <= 1:
            vals = {"pos": rng.uniform(-5, 5, 2).astype(np.float32)}
            if rng.random() < 0.5:
                vals["tag"] = rng.integers(-9, 9, 3).astype(np.int32)
            a, sa = jw.spawn(jreg, a, vals)
            b, sb = tw.spawn(treg, b, vals)
            assert int(sa) == int(sb)
        elif op == 2:
            rows = int(rng.integers(1, 6))
            vals = {"pos": rng.uniform(-5, 5, (rows, 2)).astype(np.float32)}
            count = int(rng.integers(0, rows + 1))
            a = jw.spawn_many(jreg, a, vals, count)
            b = tw.spawn_many(treg, b, vals, count)
        elif op == 3:
            slot = int(rng.integers(0, CAP))
            a = jw.despawn(jreg, a, slot, frame)
            b = tw.despawn(treg, b, slot, frame)
        elif op == 4:
            mask = rng.random(CAP) < 0.2
            a = jw.despawn_where(jreg, a, jnp.asarray(mask), frame)
            b = tw.despawn_where(treg, b, torch.from_numpy(mask), frame)
        elif op == 5:
            confirmed = frame - int(rng.integers(0, 4))
            a = jw.despawn_confirmed(jreg, a, confirmed)
            b = tw.despawn_confirmed(treg, b, confirmed)
        elif op == 6:
            slot = int(rng.integers(0, CAP))
            if rng.random() < 0.5:
                val = rng.integers(-9, 9, 3).astype(np.int32)
                a = jw.insert_component(jreg, a, slot, "tag", val)
                b = tw.insert_component(treg, b, slot, "tag", val)
            else:
                a = jw.remove_component(jreg, a, slot, "pos")
                b = tw.remove_component(treg, b, slot, "pos")
        else:
            if rng.random() < 0.5:
                val = {"dir": np.float32(rng.uniform(-1, 1)),
                       "gust": np.int32(rng.integers(0, 9))}
                a = jw.insert_resource(jreg, a, "wind", val)
                b = tw.insert_resource(treg, b, "wind", val)
            else:
                a = jw.remove_resource(jreg, a, "score")
                b = tw.remove_resource(treg, b, "score")
        assert_worlds_equal(a, b)
    assert int(jw.active_count(a)) == int(tw.active_count(b))


def test_slot_reuse_after_retirement():
    jreg, treg = make_regs()
    a, b = jreg.init_state(), treg.init_state("cpu")
    for _ in range(3):
        a, _ = jw.spawn(jreg, a, {})
        b, _ = tw.spawn(treg, b, {})
    a = jw.despawn(jreg, a, 1, 5)
    b = tw.despawn(treg, b, 1, 5)
    a = jw.despawn_confirmed(jreg, a, 5)
    b = tw.despawn_confirmed(treg, b, 5)
    a, sa = jw.spawn(jreg, a, {})
    b, sb = tw.spawn(treg, b, {})
    assert int(sa) == int(sb) == 1  # the freed slot, with a fresh id
    assert int(b.rollback_id[1]) == 3
    assert_worlds_equal(a, b)


def test_overflow_flag_and_full_world():
    jreg, treg = make_regs()
    a, b = jreg.init_state(), treg.init_state("cpu")
    vals = {"pos": np.ones((CAP + 3, 2), np.float32)}
    a = jw.spawn_many(jreg, a, vals, CAP + 3)
    b = tw.spawn_many(treg, b, vals, CAP + 3)
    assert bool(b.overflow)
    a, sa = jw.spawn(jreg, a, {"pos": np.zeros(2, np.float32)})
    b, sb = tw.spawn(treg, b, {"pos": np.zeros(2, np.float32)})
    assert int(sa) == int(sb) == -1
    assert_worlds_equal(a, b)


def test_world_round_trips_through_numpy():
    jreg, treg = make_regs()
    a, _ = jw.spawn(jreg, jreg.init_state(), {"pos": np.array([1.0, 2.0], np.float32)})
    b = world_from_numpy(treg, jax_leaves(a), "cpu")
    assert_worlds_equal(a, b)
    assert_worlds_equal(a, world_from_numpy(treg, world_to_numpy(b), "cpu"))


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import importlib, pkgutil, runpy, sys\n"
        "import bevy_ggrs_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "for cli in CLIS:\n"
        "    runpy.run_path(cli, run_name='cli_import_check')\n"
        "missing = [m for m in sys.argv[1:] if m not in sys.modules]\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'bevy_ggrs_tpu' or m.startswith('bevy_ggrs_tpu.')\n"
        "       or m == 'ml_dtypes' or m.startswith('ml_dtypes.')]\n"
        "print(len(list(pkgutil.walk_packages(pkg.__path__))), bad, missing)\n"
        "sys.exit(1 if bad or missing else 0)\n"
    )
    # the session layer and checksum readback, each module by name
    expected = [f"bevy_ggrs_tpu_torch.session.{m}" for m in (
        "events", "requests", "input_queue", "time_sync", "protocol", "transport",
        "channel", "p2p", "spectator", "builder", "native", "synctest")]
    expected += ["bevy_ggrs_tpu_torch.snapshot.lazy", "bevy_ggrs_tpu_torch.runner"]
    # the telemetry package, each module by name (it never imports jax)
    expected += ["bevy_ggrs_tpu_torch.telemetry", "bevy_ggrs_tpu_torch.utils.tracing"]
    expected += [f"bevy_ggrs_tpu_torch.telemetry.{m}" for m in (
        "metrics", "flight", "timeline", "phases", "devmem", "forensics", "netstats",
        "qos", "prometheus", "trace")]
    # the many-worlds slice
    expected += ["bevy_ggrs_tpu_torch.batch_runner", "bevy_ggrs_tpu_torch.ops.batch",
                 "bevy_ggrs_tpu_torch.ops.variant_probe", "bevy_ggrs_tpu_torch.snapshot.strategy"]
    # the megastep, the game surface and its formats
    expected += ["bevy_ggrs_tpu_torch.ops.megastep", "bevy_ggrs_tpu_torch.utils.threefry",
                 "bevy_ggrs_tpu_torch.snapshot.persist", "bevy_ggrs_tpu_torch.session.replay",
                 "bevy_ggrs_tpu_torch.session.room", "bevy_ggrs_tpu_torch.models.particles",
                 "bevy_ggrs_tpu_torch.models.crowd", "bevy_ggrs_tpu_torch.models.pong"]
    # the fleet, the compile guard and the platform helper
    expected += [f"bevy_ggrs_tpu_torch.fleet.{m}" for m in (
        "protocol", "lobby", "observe", "scheduler", "worker")]
    expected += ["bevy_ggrs_tpu_torch.fleet", "bevy_ggrs_tpu_torch.utils.compile_guard",
                 "bevy_ggrs_tpu_torch.utils.platform"]
    # multi-device: the lobby and entity meshes, multi-host set-up
    expected += ["bevy_ggrs_tpu_torch.parallel", "bevy_ggrs_tpu_torch.parallel.mesh",
                 "bevy_ggrs_tpu_torch.parallel.multihost"]
    # the port's CLIs and the examples' twins, their top-level imports run
    # (not their mains; on the CPU, as a twin asks for the card otherwise)
    clis = [str(ROOT / "scripts" / f"torch_{n}.py")
            for n in ("fleet_worker", "fleet_scheduler", "replay_tool", "room_server",
                      "e2e_p2p_check", "parity_check")]
    clis += sorted(str(p) for p in (ROOT / "examples_torch").glob("*.py"))
    assert len(clis) == 6 + 7
    code = f"CLIS = {clis!r}\n" + code
    res = subprocess.run([sys.executable, "-c", code, *expected], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "BGT_PLATFORM": "cpu"})
    assert res.returncode == 0, res.stdout + res.stderr
    # chip_smoke.py and the CLIs drive the port only, in any function too
    import ast

    for path in [ROOT / "chip_smoke.py", *map(Path, clis)]:
        tree = ast.parse(path.read_text())
        names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
        names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]
        assert not [n for n in names if n.split(".")[0] in ("jax", "bevy_ggrs_tpu", "ml_dtypes")]


def test_entry_points_refuse_to_fall_back_to_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        App()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_fixed_point.make_app()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tw.Registry(4).init_state()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    # the many-worlds entry points take their device from the app
    from bevy_ggrs_tpu_torch import BatchedRunner, BucketedWaveExecutor, SyncTestSession
    from bevy_ggrs_tpu_torch.models import stress as t_stress

    for entry in (lambda: BatchedRunner(t_stress.make_app(8), [SyncTestSession(2)]),
                  lambda: BucketedWaveExecutor(t_stress.make_app(8), 4)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            entry()
    # this slice's entry points: the seeded App, the models, the megastep
    # runner (its app), a checkpoint load and a replay's runner
    from bevy_ggrs_tpu_torch.models import crowd, particles, pong
    from bevy_ggrs_tpu_torch.snapshot.persist import load_world

    for entry in (lambda: App(seed=3), lambda: particles.make_app(rate=2),
                  lambda: crowd.make_app(n_per_team=4), pong.make_app,
                  lambda: load_world("unread.npz", tw.Registry(4))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            entry()
    assert resolve_device("cpu").type == "cpu"
    # with an explicit CPU request, the whole path runs on the CPU
    app = t_fixed_point.make_app(device="cpu")
    runner = GgrsRunner(app, SessionBuilder.for_app(app).start_synctest_session())
    runner.tick()
    assert runner.world.device.type == "cpu"
