"""Snapshot strategies on the port, held against the JAX package.

Mirrors ``tests/test_component_rollback.py`` (all four tests): every
strategy round-trips component values through continuous SyncTest
resimulation with the value == frame-count invariant, a custom store/load
bijection too, ``QuantizeStrategy`` keeps a checksummed float column in
bf16 with no mismatch, and several disjoint component types advance only
where present.  Each case runs the same app in both packages: integer
columns and checksums bit for bit, float states within ``atol=1e-4,
rtol=0`` (XLA's FMAs, ROADMAP queue C).  The bf16 stored form itself is
held bit for bit against ``astype(jnp.bfloat16)`` on seeded values."""

import dataclasses

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import bevy_ggrs_tpu as J
import bevy_ggrs_tpu.snapshot as JS
import bevy_ggrs_tpu_torch as T
import bevy_ggrs_tpu_torch.snapshot as TS
from bevy_ggrs_tpu_torch.convert import to_numpy, world_from_numpy, world_to_numpy

FLOAT_ATOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes, and
    idle OpenMP threads spinning here would take cores from the
    wall-clock-driven games of other files."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _where(pkg, m, a, b):
    return jnp.where(m, a, b) if pkg is J else torch.where(m, a, b)


def _app(pkg, capacity=4):
    kw = {} if pkg is J else {"device": "cpu"}
    return pkg.App(num_players=1, capacity=capacity, input_shape=(),
                   input_dtype=np.uint8, **kw)


def _dtype(pkg, name):
    return getattr(jnp if pkg is J else torch, name)


def _strategies(pkg, name):
    if name == "custom":
        # stored doubled, halved on load: the Strategy bijection contract
        return pkg.snapshot.Strategy(store=lambda a: a * 2, load=lambda a: a // 2)
    return {"copy": pkg.CopyStrategy if pkg is J else TS.CopyStrategy,
            "clone": pkg.CloneStrategy if pkg is J else TS.CloneStrategy,
            "reflect": pkg.ReflectStrategy if pkg is J else TS.ReflectStrategy}[name]


def counter_app(pkg, strategy):
    S = JS if pkg is J else TS
    app = _app(pkg)
    app.rollback_component("v", (), _dtype(pkg, "int32"), checksum=True,
                           strategy=strategy)

    def step(world, ctx):
        m = S.active_mask(world) & world.has["v"]
        return dataclasses.replace(
            world, comps={"v": _where(pkg, m, world.comps["v"] + 1, world.comps["v"])})

    def setup(world):
        world, _ = S.spawn(app.reg, world, {"v": 0})
        return world

    app.set_step(step)
    app.set_setup(setup)
    return app


def quantized_app(pkg):
    S = JS if pkg is J else TS
    app = _app(pkg)
    quant = J.QuantizeStrategy() if pkg is J else TS.QuantizeStrategy()
    app.rollback_component("x", (), _dtype(pkg, "float32"), strategy=quant,
                           checksum=True)
    app.rollback_component("n", (), _dtype(pkg, "int32"), checksum=True)

    def step(world, ctx):
        m = S.active_mask(world)
        c = world.comps
        return dataclasses.replace(world, comps={
            "x": _where(pkg, m & world.has["x"], c["x"] * np.float32(1.001)
                        + np.float32(0.01), c["x"]),
            "n": _where(pkg, m & world.has["n"], c["n"] + 1, c["n"]),
        })

    def setup(world):
        # 0.3 is not bf16-exact: the frame-0 snapshot must restore exactly
        # the live starting state (the initial round trip)
        world, _ = S.spawn(app.reg, world, {"x": 0.3, "n": 0})
        return world

    app.set_step(step)
    app.set_setup(setup)
    return app


def disjoint_app(pkg):
    S = JS if pkg is J else TS
    app = _app(pkg, capacity=64)
    for name in ("a", "b", "c"):
        app.rollback_component(name, (), _dtype(pkg, "int32"), checksum=True)

    def step(world, ctx):
        comps = dict(world.comps)
        m = S.active_mask(world)
        for name in ("a", "b", "c"):
            comps[name] = _where(pkg, m & world.has[name], comps[name] + 1, comps[name])
        return dataclasses.replace(world, comps=comps)

    def setup(world):
        for i in range(20):
            world, _ = S.spawn(app.reg, world, {("a", "b", "c")[i % 3]: 0})
        return world

    app.set_step(step)
    app.set_setup(setup)
    return app


def run(pkg, app, ticks=15, check_distance=3):
    session = pkg.SyncTestSession(num_players=1, input_shape=(), input_dtype=np.uint8,
                                  check_distance=check_distance)
    mismatches = []
    kw = {"pipeline": False} if pkg is J else {}
    runner = pkg.GgrsRunner(app, session, on_mismatch=mismatches.append, **kw)
    stream = []
    for _ in range(ticks):
        runner.tick()
        stream.append(runner.checksum)
    runner.finish()
    return runner, mismatches, stream


def both(make, ticks=15, **kw):
    """Run ``make(pkg)`` in both packages; returns ``(port, jax)`` tuples of
    ``(runner, mismatches, checksum stream)``."""
    return run(T, make(T), ticks, **kw), run(J, make(J), ticks, **kw)


@pytest.mark.parametrize("strategy", ["copy", "clone", "reflect"])
def test_value_equals_frame_count(strategy):
    (port, pm, ps), (jr, jm, js) = both(lambda pkg: counter_app(pkg, _strategies(pkg, strategy)))
    assert pm == jm == []
    assert int(port.world.comps["v"][0]) == int(jr.world.comps["v"][0]) == 15
    assert ps == js


def test_custom_store_load_strategy():
    (port, pm, ps), (jr, jm, js) = both(lambda pkg: counter_app(pkg, _strategies(pkg, "custom")))
    assert pm == jm == []
    assert int(port.world.comps["v"][0]) == int(jr.world.comps["v"][0]) == 15
    assert ps == js


def test_quantize_strategy_float_state():
    (port, pm, _ps), (jr, jm, _js) = both(quantized_app)
    assert pm == jm == []
    assert int(port.world.comps["n"][0]) == int(jr.world.comps["n"][0]) == 15
    x = float(port.world.comps["x"][0])
    assert x > 0.3
    # the live state is canonical: a bf16 value held in a float32 column
    xs = port.world.comps["x"]
    assert torch.equal(xs, xs.to(torch.bfloat16).to(torch.float32))
    np.testing.assert_allclose(to_numpy(xs), np.asarray(jr.world.comps["x"]),
                               rtol=0, atol=FLOAT_ATOL)


def test_multiple_disjoint_component_types():
    (port, pm, ps), (jr, jm, js) = both(disjoint_app, ticks=12)
    assert pm == jm == []
    for i, name in enumerate(("a", "b", "c")):
        assert int(port.world.comps[name][i]) == 12
        assert bool(port.world.has[name][i])
        assert np.array_equal(to_numpy(port.world.comps[name]),
                              np.asarray(jr.world.comps[name]))
    assert ps == js


def test_quantized_store_bits_equal_jax_astype():
    """The stored bf16 bits and the restored float32 state, bit for bit
    against the JAX package's strategy on seeded values (round to nearest
    even, ties, subnormals, infinities and NaN included)."""
    rng = np.random.default_rng(5)
    vals = np.concatenate([
        rng.standard_normal(4096).astype(np.float32) * np.float32(1e3),
        rng.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32).view(np.float32),
        np.array([0.3, -0.0, 1e-40, -1e-39, np.inf, -np.inf, 65504.0,
                  1.00390625, 1.01171875, 3.4e38], np.float32),
    ])
    vals = vals[~np.isnan(vals)]  # NaN payloads: compared by isnan below
    j_reg, t_reg = JS.Registry(len(vals)), TS.Registry(len(vals))
    j_reg.register_component("x", (), jnp.float32, strategy=J.QuantizeStrategy())
    t_reg.register_component("x", (), torch.float32, strategy=TS.QuantizeStrategy())
    jw = dataclasses.replace(j_reg.init_state(), comps={"x": jnp.asarray(vals)})
    tw = dataclasses.replace(t_reg.init_state("cpu"), comps={"x": torch.from_numpy(vals)})
    j_stored, t_stored = j_reg.store_state(jw), t_reg.store_state(tw)
    assert t_stored.comps["x"].dtype == torch.bfloat16
    assert np.array_equal(
        to_numpy(t_stored.comps["x"]).view(np.uint16),
        np.asarray(j_stored.comps["x"]).view(np.uint16))
    j_back, t_back = j_reg.load_state(j_stored), t_reg.load_state(t_stored)
    assert t_back.comps["x"].dtype == torch.float32
    assert np.array_equal(to_numpy(t_back.comps["x"]).view(np.uint32),
                          np.asarray(j_back.comps["x"]).view(np.uint32))
    nan = torch.tensor([np.nan], dtype=torch.float32)
    assert torch.isnan(TS.QuantizeStrategy().store(nan).float()).all()
    assert ml_dtypes.bfloat16 == np.asarray(j_stored.comps["x"]).dtype


def test_quantized_stored_form_carries_across():
    """A JAX world's bf16 stored form crosses into the port and back bit for
    bit (``convert.py``), and loads to the port's live state."""
    rng = np.random.default_rng(2)
    vals = rng.standard_normal(8).astype(np.float32)
    j_reg, t_reg = JS.Registry(8), TS.Registry(8)
    j_reg.register_component("x", (), jnp.float32, strategy=J.QuantizeStrategy())
    t_reg.register_component("x", (), torch.float32, strategy=TS.QuantizeStrategy())
    j_stored = j_reg.store_state(dataclasses.replace(j_reg.init_state(),
                                                     comps={"x": jnp.asarray(vals)}))
    leaves = {f.name: jax_tree_numpy(getattr(j_stored, f.name))
              for f in dataclasses.fields(j_stored)}
    stored = world_from_numpy(t_reg, leaves, "cpu")
    assert stored.comps["x"].dtype == torch.bfloat16
    back = world_to_numpy(stored)
    assert np.array_equal(back["comps"]["x"].view(np.uint16),
                          leaves["comps"]["x"].view(np.uint16))
    live = t_reg.load_state(stored).comps["x"]
    assert np.array_equal(live.numpy(), np.asarray(j_reg.load_state(j_stored).comps["x"]))


def jax_tree_numpy(tree):
    import jax

    return jax.tree.map(np.asarray, tree)


def test_port_stored_form_loads_in_the_jax_package():
    """The port's bf16 stored form crosses into the JAX package: its raw
    ``|V2`` words, viewed as ``ml_dtypes.bfloat16``, build a JAX stored
    world that loads to the port's live state bit for bit."""
    import jax

    rng = np.random.default_rng(4)
    vals = (rng.standard_normal((16, 2)) * 100).astype(np.float32)
    j_reg, t_reg = JS.Registry(16), TS.Registry(16)
    j_reg.register_component("x", (2,), jnp.float32, strategy=J.QuantizeStrategy())
    t_reg.register_component("x", (2,), torch.float32, strategy=TS.QuantizeStrategy())
    t_stored = t_reg.store_state(dataclasses.replace(t_reg.init_state("cpu"),
                                                     comps={"x": torch.from_numpy(vals)}))
    leaves = world_to_numpy(t_stored)
    assert leaves["comps"]["x"].dtype == np.dtype("V2")

    def as_jax(a):
        return jnp.asarray(a.view(ml_dtypes.bfloat16) if a.dtype == np.dtype("V2") else a)

    j_stored = JS.WorldState(**{f.name: jax.tree.map(as_jax, leaves[f.name])
                                for f in dataclasses.fields(JS.WorldState)})
    assert j_stored.comps["x"].dtype == jnp.bfloat16
    j_live = np.asarray(j_reg.load_state(j_stored).comps["x"])
    t_live = t_reg.load_state(t_stored).comps["x"].numpy()
    assert j_live.dtype == np.float32
    assert np.array_equal(j_live.view(np.uint32), t_live.view(np.uint32))
    assert not np.array_equal(j_live, vals)  # the stored form really is lossy
