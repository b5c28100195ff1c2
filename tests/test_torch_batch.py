"""The port's many-worlds waves (``ops/batch.py``), held against the JAX
package and against the port's own solo resim.

Mirrors ``tests/test_batched_lobbies.py`` (both tests; the spawning case
with a spawn/despawn step this file defines in both frameworks, since
``particles`` waits for its threefry port) and the executor tests of
``tests/test_batched_runner.py`` (buckets and counters, exact against
padded).  Besides: per-lane clocks, including starts that straddle
``I32_MAX``, bit for bit against the solo resim and the JAX wave; the
masked and packed wave functions; ``stack_worlds``/``unstack_world``;
``plan_row_gather`` and the fused loads and gathers; the canonical
refusal; the draft-lane scheduler; and the variant probe.

Tolerances: integers, checksums, masks and bucket histograms exact;
float states against JAX within ``atol=1e-4, rtol=0`` (XLA's FMAs,
ROADMAP queue C); a lane against the port's solo resim bit for bit."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bevy_ggrs_tpu as J
import bevy_ggrs_tpu.ops.batch as JB
import bevy_ggrs_tpu.snapshot as JS
import bevy_ggrs_tpu.snapshot.lazy as JL
import bevy_ggrs_tpu_torch as T
import bevy_ggrs_tpu_torch.ops.batch as TB
import bevy_ggrs_tpu_torch.snapshot as TS
import bevy_ggrs_tpu_torch.snapshot.lazy as TL
from bevy_ggrs_tpu.models import fixed_point as j_fixed_point
from bevy_ggrs_tpu.models import stress as j_stress
from bevy_ggrs_tpu_torch.convert import to_numpy, world_from_numpy, world_to_numpy
from bevy_ggrs_tpu_torch.models import fixed_point, stress
from bevy_ggrs_tpu_torch.ops import resim as R
from bevy_ggrs_tpu_torch.ops.packing import PackedWave, pack_prefix, pack_row, wave_starts
from bevy_ggrs_tpu_torch.utils.frames import I32_MAX
from bevy_ggrs_tpu_torch.utils.tree import tree_flatten

FLOAT_ATOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(rng, m, k, players):
    return rng.integers(0, 8, size=(m, k, players)).astype(np.uint8)


def assert_worlds_equal(a, b):
    for x, y in zip(tree_flatten(a), tree_flatten(b)):
        assert torch.equal(x, y)


def assert_like_jax(port_world, jax_world, exact):
    got = world_to_numpy(port_world)
    want = jax.tree.map(np.asarray, {f.name: getattr(jax_world, f.name)
                                     for f in dataclasses.fields(jax_world)})
    for n in got["comps"]:
        if exact or got["comps"][n].dtype.kind != "f":
            assert np.array_equal(got["comps"][n], want["comps"][n]), n
        else:
            np.testing.assert_allclose(got["comps"][n], want["comps"][n], rtol=0,
                                       atol=FLOAT_ATOL, err_msg=n)
    for f in ("alive", "rollback_id", "despawn_pending", "despawn_frame", "next_id"):
        assert np.array_equal(got[f], want[f]), f


MODELS = {
    "stress": (lambda: stress.make_app(256, capacity=256, device="cpu"),
               lambda: j_stress.make_app(256, capacity=256), False),
    "fixed_point": (lambda: fixed_point.make_app(device="cpu"), j_fixed_point.make_app, True),
}


# -- tests/test_batched_lobbies.py -----------------------------------------------


@pytest.mark.parametrize("model", list(MODELS))
def test_batched_lobbies_bit_identical_to_independent_runs(model):
    make, jmake, exact = MODELS[model]
    m, k, p = 4, 6, 2
    app, japp = make(), jmake()
    rng = np.random.default_rng(11)
    inputs = _inputs(rng, m, k, p)
    status = np.zeros((m, k, p), np.int8)
    starts = np.array([0, 7, 100, 1000], np.int32)  # lobbies not in lockstep
    worlds = [app.init_state() for _ in range(m)]
    R.vmap_fallbacks = 0
    finals, stacked, checks = TB.make_batched_resim_fn(app)(
        TB.stack_worlds(worlds), inputs, status, starts)
    assert R.vmap_fallbacks == 0 and checks.shape == (m, k, 2)
    for b in range(m):
        one, one_stacked, one_checks = app.resim_fn(worlds[b], inputs[b], status[b],
                                                    int(starts[b]))
        assert torch.equal(one_checks, checks[b]), f"lobby {b}"
        assert_worlds_equal(TB.unstack_world(finals, b), one)
        assert_worlds_equal(TB.unstack_world(stacked, b), one_stacked)
    jf, _js, jc = JB.make_batched_resim_fn(japp)(
        JB.stack_worlds([japp.init_state() for _ in range(m)]), inputs, status, starts)
    assert_like_jax(finals, jf, exact)
    if exact:
        assert np.array_equal(checks.numpy(), np.asarray(jc).astype(np.int64))


def spawner_app(pkg, capacity=12):
    """Every frame: despawn the slot ``frame % capacity`` and spawn one
    entity whose value is the frame's first input; a step with index
    writes at a per-lane slot (``spawn``, ``despawn``,
    ``insert_component``) that the test defines in both frameworks."""
    S = JS if pkg is J else TS
    xp = jnp if pkg is J else torch
    kw = {} if pkg is J else {"device": "cpu"}
    app = pkg.App(num_players=2, capacity=capacity, input_shape=(), input_dtype=np.uint8,
                  retention=4, **kw)
    app.rollback_component("v", (), xp.int32, checksum=True)
    app.rollback_component("tag", (), xp.int32, checksum=True)

    def step(world, ctx):
        world = S.despawn(app.reg, world, ctx.frame % capacity, ctx.frame)
        world, slot = S.spawn(app.reg, world, {"v": ctx.inputs[0]})
        world = S.insert_component(app.reg, world, slot, "tag", ctx.frame)
        m = S.active_mask(world) & world.has["v"]
        return dataclasses.replace(world, comps={
            **world.comps, "v": xp.where(m, world.comps["v"] + 1, world.comps["v"])})

    app.set_step(step)
    return app


def test_batched_lobbies_with_spawns():
    m, k = 3, 9
    app, japp = spawner_app(T), spawner_app(J)
    rng = np.random.default_rng(3)
    inputs = _inputs(rng, m, k, 2)
    status = np.zeros((m, k, 2), np.int8)
    starts = np.array([0, 5, 31], np.int32)
    worlds = [app.init_state() for _ in range(m)]
    R.vmap_fallbacks = 0
    finals, _stacked, checks = TB.make_batched_resim_fn(app)(
        TB.stack_worlds(worlds), inputs, status, starts)
    assert R.vmap_fallbacks == 0
    for b in range(m):
        one, _, one_checks = app.resim_fn(worlds[b], inputs[b], status[b], int(starts[b]))
        assert torch.equal(one_checks, checks[b])
        assert_worlds_equal(TB.unstack_world(finals, b), one)
    assert int(finals.next_id[0]) == k
    jf, _js, jc = JB.make_batched_resim_fn(japp)(
        JB.stack_worlds([japp.init_state() for _ in range(m)]), inputs, status, starts)
    assert np.array_equal(checks.numpy(), np.asarray(jc).astype(np.int64))
    assert_like_jax(finals, jf, True)


# -- per-lane clocks -----------------------------------------------------------------


def clock_app(pkg):
    """A step that writes its clock into the world: the frame, the retire
    horizon and the time, per entity."""
    S = JS if pkg is J else TS
    xp = jnp if pkg is J else torch
    kw = {} if pkg is J else {"device": "cpu"}
    app = pkg.App(num_players=1, capacity=2, input_shape=(), input_dtype=np.uint8,
                  retention=5, fps=60, **kw)
    for name, dt in (("f", xp.int32), ("r", xp.int32), ("t", xp.float32)):
        # the time is a float state: out of the checksum held against JAX
        app.rollback_component(name, (), dt, checksum=name != "t")

    def step(world, ctx):
        one = xp.ones_like(world.comps["f"])
        return dataclasses.replace(world, comps={
            "f": one * ctx.frame, "r": one * ctx.retire_frame,
            "t": xp.ones_like(world.comps["t"]) * ctx.time_seconds})

    def setup(world):
        world, _ = S.spawn(app.reg, world, {"f": 0, "r": 0, "t": 0.0})
        return world

    app.set_step(step)
    app.set_setup(setup)
    return app


@pytest.mark.parametrize("starts", [[0, 7, 100, 1000],
                                    [I32_MAX - 3, I32_MAX, -(2**31), -5]],
                         ids=["spread", "straddle-i32-max"])
def test_lane_clocks_equal_solo_and_jax(starts):
    m, k = len(starts), 6
    app, japp = clock_app(T), clock_app(J)
    inputs = np.zeros((m, k, 1), np.uint8)
    status = np.zeros((m, k, 1), np.int8)
    starts = np.array(starts, np.int32)
    worlds = [app.init_state() for _ in range(m)]
    finals, stacked, checks = TB.make_batched_resim_fn(app)(
        TB.stack_worlds(worlds), inputs, status, starts)
    for b in range(m):
        one, one_stacked, one_checks = app.resim_fn(worlds[b], inputs[b], status[b],
                                                    int(starts[b]))
        assert_worlds_equal(TB.unstack_world(stacked, b), one_stacked)
        assert torch.equal(one_checks, checks[b])
    frames, retire, times = R.lane_clocks(torch.from_numpy(starts), k, 5, 60)
    want = (starts.astype(np.int64)[:, None] + np.arange(1, k + 1)).astype(np.int32)
    assert np.array_equal(frames.numpy(), want)
    assert np.array_equal(stacked.comps["f"][:, :, 0].numpy(), want)
    assert np.array_equal(retire.numpy(), (want.astype(np.int64) - 5).astype(np.int32))
    assert np.array_equal(times.numpy().view(np.uint32),
                          (want.astype(np.float32) / np.float32(60)).view(np.uint32))
    _jf, js, jc = JB.make_batched_resim_fn(japp)(
        JB.stack_worlds([japp.init_state() for _ in range(m)]), inputs, status, starts)
    for n in ("f", "r"):
        assert np.array_equal(to_numpy(stacked.comps[n]), np.asarray(js.comps[n])), n
    # XLA divides by the constant fps as a reciprocal product (1 ulp off at
    # some frames); the port divides exactly, on the solo path and on the
    # lanes alike (ROADMAP queue C)
    np.testing.assert_allclose(to_numpy(stacked.comps["t"]), np.asarray(js.comps["t"]),
                               rtol=0, atol=FLOAT_ATOL)
    assert np.array_equal(checks.numpy(), np.asarray(jc).astype(np.int64))


# -- the masked, exact and packed wave functions ---------------------------------------


def _packed_wave(app, inputs, status, starts, ks):
    spec = app.packed_spec
    m, k = inputs.shape[:2]
    buf = spec.new_batch_buffer(m, k)
    for b in range(m):
        pack_prefix(buf[b], int(starts[b]), int(ks[b]))
        for i in range(k):
            pack_row(spec, buf[b], i, inputs[b, i], status[b, i])
    return buf


def test_masked_exact_and_packed_waves():
    m, k = 3, 4
    app = fixed_point.make_app(device="cpu")
    rng = np.random.default_rng(5)
    inputs = _inputs(rng, m, k, 2)
    status = rng.integers(0, 2, (m, k, 2)).astype(np.int8)
    starts = np.array([3, 40, I32_MAX - 1], np.int32)
    worlds = TB.stack_worlds([app.init_state() for _ in range(m)])
    n_real = [4, 0, 2]
    f_pad, s_pad, c_pad = TB.make_batched_padded_fn(app, k)(worlds, inputs, status, starts,
                                                            n_real)
    assert c_pad.shape == (m * k, 2)
    for b in range(m):
        w = TB.unstack_world(worlds, b)
        one, one_s, one_c = R.resim_padded(app.reg, app.step, w, inputs[b], status[b],
                                           int(starts[b]), n_real[b], app.retention, app.fps)
        assert torch.equal(c_pad[b * k:(b + 1) * k], one_c)  # row b * k + i
        assert_worlds_equal(TB.unstack_world(f_pad, b), one)
        assert_worlds_equal(TB.unstack_world(s_pad, b), one_s)
    buf = _packed_wave(app, inputs, status, starts, n_real)
    rows = torch.from_numpy(buf)
    assert torch.equal(wave_starts(rows), torch.from_numpy(starts))
    f_pk, s_pk, c_pk = TB.make_batched_packed_padded_fn(app, k)(
        worlds, PackedWave(rows, tuple(n_real)))
    assert torch.equal(c_pk, c_pad)
    assert_worlds_equal(f_pk, f_pad)
    # the exact wave (every lane k frames) against the masked one at n_real=k
    f_ex, s_ex, c_ex = TB.make_batched_exact_fn(app, k)(worlds, inputs, status, starts)
    f_full, s_full, c_full = TB.make_batched_padded_fn(app, k)(worlds, inputs, status,
                                                               starts, [k] * m)
    assert torch.equal(c_ex, c_full)
    assert_worlds_equal(f_ex, f_full)
    assert_worlds_equal(s_ex, s_full)
    f_pe, _s, c_pe = TB.make_batched_packed_exact_fn(app, k)(
        worlds, PackedWave(torch.from_numpy(_packed_wave(app, inputs, status, starts,
                                                         [k] * m)), (k,) * m))
    assert torch.equal(c_pe, c_ex)
    assert_worlds_equal(f_pe, f_ex)
    # the JAX masked wave on the same inputs: integer model, exact
    japp = j_fixed_point.make_app()
    jw = JB.stack_worlds([japp.init_state() for _ in range(m)])
    jf, _js, jc = JB.make_batched_padded_fn(japp, k)(jw, inputs, status, starts,
                                                     np.asarray(n_real, np.int32))
    assert np.array_equal(c_pad.numpy(), np.asarray(jc).astype(np.int64))
    assert_like_jax(f_pad, jf, True)


def test_stack_and_unstack_carry_across_from_jax():
    japp, app = j_fixed_point.make_app(), fixed_point.make_app(device="cpu")
    rng = np.random.default_rng(1)
    jworlds = []
    for i in range(3):
        w, _, _ = japp.resim_fn(japp.init_state(), _inputs(rng, 1, 2 + i, 2)[0],
                                np.zeros((2 + i, 2), np.int8), 0)
        jworlds.append(w)
    jstacked = JB.stack_worlds(jworlds)
    leaves = jax.tree.map(np.asarray, {f.name: getattr(jstacked, f.name)
                                       for f in dataclasses.fields(jstacked)})
    stacked = world_from_numpy(app.reg, leaves, "cpu")  # a stacked [M, ...] JAX world
    assert stacked.alive.shape == (3, app.reg.capacity)
    for b in range(3):
        assert_like_jax(TB.unstack_world(stacked, b), JB.unstack_world(jstacked, b), True)
    again = TB.stack_worlds([TB.unstack_world(stacked, b) for b in range(3)])
    assert_worlds_equal(again, stacked)


# -- tests/test_batched_runner.py: the executor ----------------------------------------


def test_bucketed_executor_buckets_and_counters():
    for k_max in (12, 8, 1):
        assert TB.bucket_sizes(k_max) == JB.bucket_sizes(k_max)
    assert TB.bucket_sizes(12) == (1, 2, 4, 8, 12)
    m, k = 3, 5
    app, japp = stress.make_app(32, capacity=32, device="cpu"), j_stress.make_app(32, capacity=32)
    worlds = TB.stack_worlds([app.init_state() for _ in range(m)])
    jworlds = JB.stack_worlds([japp.init_state() for _ in range(m)])
    ex, jex = TB.BucketedWaveExecutor(app, k), JB.BucketedWaveExecutor(japp, k)
    assert ex.bucket_for(1) == 1 and ex.bucket_for(3) == 4 and ex.bucket_for(5) == 5
    with pytest.raises(ValueError):
        ex.bucket_for(6)
    inputs = np.zeros((m, k, 2), np.uint8)
    status = np.zeros((m, k, 2), np.int8)
    starts = np.zeros((m,), np.int32)
    waves = [[1, 1, 1], [3, 0, 1]] * 4
    for ks in waves:
        bucket, _f, _s, checks = ex.run_wave(worlds, inputs, status, starts, ks)
        jbucket, _jf, _js, _jc = jex.run_wave(jworlds, inputs, status, starts, ks)
        assert bucket == jbucket and checks.shape == (m * bucket, 2)
    st, jst = ex.stats(), jex.stats()
    assert st["bucket_hist"] == jst["bucket_hist"] == {1: 4, 4: 4}
    assert st["wave_dispatches"] == jst["wave_dispatches"] == 8
    assert st["program_compiles"] == 2  # the same shapes reuse their programs
    assert st["host_uploads"] == 3 * 8
    with pytest.raises(ValueError, match="at least one"):
        ex.run_wave(worlds, inputs, status, starts, [0, 0, 0])


def test_bucketed_executor_exact_matches_padded():
    m, k = 2, 4
    app = stress.make_app(64, capacity=64, device="cpu")
    worlds = TB.stack_worlds([app.init_state() for _ in range(m)])
    inputs = np.random.default_rng(7).integers(0, 16, size=(m, k, 2), dtype=np.uint8)
    status = np.zeros((m, k, 2), np.int8)
    starts = np.zeros((m,), np.int32)
    _b, f_exact, s_exact, c_exact = TB.BucketedWaveExecutor(app, k).run_wave(
        worlds, inputs, status, starts, [k] * m)
    f_pad, s_pad, c_pad = TB.make_batched_padded_fn(app, k)(worlds, inputs, status, starts,
                                                            [k] * m)
    assert torch.equal(c_exact, c_pad)
    assert_worlds_equal(f_exact, f_pad)
    assert_worlds_equal(s_exact, s_pad)
    japp = j_stress.make_app(64, capacity=64)
    _jb, jf, _js, _jc = JB.BucketedWaveExecutor(japp, k).run_wave(
        JB.stack_worlds([japp.init_state() for _ in range(m)]), inputs, status, starts,
        [k] * m)
    assert_like_jax(f_exact, jf, False)


def test_wave_functions_refuse_canonical_mode():
    app = fixed_point.make_app(device="cpu")
    app.canonical_depth = 8
    for build in (TB.make_batched_resim_fn, lambda a: TB.make_batched_padded_fn(a, 4),
                  lambda a: TB.make_batched_exact_fn(a, 4),
                  lambda a: TB.make_batched_packed_padded_fn(a, 4),
                  lambda a: TB.make_batched_packed_exact_fn(a, 4),
                  lambda a: TB.BucketedWaveExecutor(a, 4)):
        with pytest.raises(ValueError, match="canonical mode"):
            build(app)
    japp = j_fixed_point.make_app()
    japp.canonical_depth = 8
    with pytest.raises(ValueError, match="canonical mode"):
        JB.make_batched_resim_fn(japp)


# -- plan_row_gather and the fused loads ------------------------------------------------


def _two_stacks(app, rng):
    """A wave stack ``[3, 4, ...]`` and a resident-world stack ``[3, ...]``
    with distinct contents."""
    worlds = TB.stack_worlds([app.init_state() for _ in range(3)])
    inputs = _inputs(rng, 3, 4, 2)
    status = np.zeros((3, 4, 2), np.int8)
    finals, stacked, _ = TB.make_batched_resim_fn(app)(worlds, inputs, status,
                                                       np.array([0, 9, 70], np.int32))
    return finals, stacked


def test_plan_row_gather_and_fused_loads_equal_per_lobby_loads():
    app = fixed_point.make_app(device="cpu")
    rng = np.random.default_rng(2)
    finals, stacked = _two_stacks(app, rng)
    _f2, older = _two_stacks(app, rng)
    handles = [(0, TL.LazySlice(stacked, (2, 3))), (1, TL.LazySlice(older, (0, 1))),
               (2, TL.LazySlice(stacked, (0, 0))), (3, TL.LazySlice(finals, 1)),
               (4, TB.unstack_world(finals, 0))]
    groups, fallback = TL.plan_row_gather(handles)
    assert [(len(g[1]), g[2] is None) for g in groups] == [(2, False), (1, False), (1, True)]
    assert [t for t, _ in fallback] == [4]
    # the JAX planner groups the same handles the same way (its buffers
    # stand in as names: planning reads only their identity)
    jbufs = {id(stacked): "s", id(older): "o", id(finals): "f"}
    jgroups, jfallback = JL.plan_row_gather(
        [(t, JL.LazySlice(jbufs[id(s._stacked)], s._i)) if isinstance(s, TL.LazySlice)
         else (t, s) for t, s in handles])
    assert len(jfallback) == 1
    for g, jg in zip(groups, jgroups):
        assert jbufs[id(g[0])] == jg[0]
        assert np.array_equal(g[1], jg[1]) and np.array_equal(g[3], jg[3])
        assert (g[2] is None) == (jg[2] is None)
        if g[2] is not None:
            assert np.array_equal(g[2], jg[2])
    resident = TB.stack_worlds([app.init_state() for _ in range(5)])
    before = TL.LazySlice(TB.stack_worlds([resident]), 0).materialize()
    stager = TL.RowIndexStager(torch.device("cpu"))
    loaded = TL.fused_load_rows(resident, groups, stager)
    for t, s in handles[:4]:
        assert_worlds_equal(TB.unstack_world(loaded, t), TL.materialize(s))
    assert_worlds_equal(TB.unstack_world(loaded, 4), TB.unstack_world(resident, 4))
    assert_worlds_equal(resident, before)  # nothing written in place
    gathered = TL.fused_gather_rows(groups, stager)
    order = np.concatenate([g[3] for g in groups])
    for j, t in enumerate(order):
        assert_worlds_equal(TB.unstack_world(gathered, j), TL.materialize(handles[t][1]))
    assert_worlds_equal(TL.tree_index2(stacked, 2, 3), TL.materialize(handles[0][1]))


def test_fused_gather_maps_a_strategy_over_rows():
    reg = TS.Registry(4)
    reg.register_component("x", (), torch.float32, strategy=TS.QuantizeStrategy())
    w = reg.init_state("cpu")
    stack = TB.stack_worlds([dataclasses.replace(w, comps={"x": torch.full((4,), 0.3 + i)})
                             for i in range(3)])
    groups, _ = TL.plan_row_gather([(0, TL.LazySlice(stack, 2)), (1, TL.LazySlice(stack, 0))])
    stored = TL.fused_gather_rows(groups, TL.RowIndexStager(torch.device("cpu")),
                                  reg.store_state)
    assert stored.comps["x"].dtype == torch.bfloat16
    assert torch.equal(stored.comps["x"][0], reg.store_state(TB.unstack_world(stack, 2)).comps["x"])
    back = TL.fused_load_rows(stack, TL.plan_row_gather([(1, TL.LazySlice(stored, 0))])[0],
                              TL.RowIndexStager(torch.device("cpu")), reg.load_state)
    assert back.comps["x"].dtype == torch.float32
    assert torch.equal(back.comps["x"][1], stored.comps["x"][0].float())


# -- the draft-lane scheduler and the probe ----------------------------------------------


def test_draft_wave_scheduler_equals_jax():
    rng = np.random.default_rng(4)
    ours, theirs = TB.DraftWaveScheduler(16), JB.DraftWaveScheduler(16)
    for _ in range(30):
        idle = sorted(rng.choice(16, rng.integers(0, 9), replace=False).tolist())
        wants = [(int(b), int(rng.integers(0, 6))) for b in rng.choice(16, 4, replace=False)]
        got = ours.plan(idle, wants)
        assert got == theirs.plan(idle, wants)
        assert {lane for _b, _c, lane in got} <= set(idle)
    assert (ours.lanes_filled, ours.dropped_candidates, ours.waves_planned) == (
        theirs.lanes_filled, theirs.dropped_candidates, theirs.waves_planned)


@pytest.mark.parametrize("model", ["stress", "spawner"])
def test_variant_probe_finds_the_port_stable(model):
    app = (stress.make_app(64, capacity=64, device="cpu") if model == "stress"
           else spawner_app(T))
    report = T.probe_program_variants(app, trials=9, k_long=4, warmup_frames=3, lanes=3)
    assert report.stable, report.summary()
    assert report.trials == 9 and report.checked_lengths == (1, 4) and report.lanes == 3
    assert report.summary().startswith("stable")
    bad = T.VariantProbeReport(trials=4, mismatching_trials=0, first_example=None,
                               checked_lengths=(1, 4), lanes=3, lane_mismatching_trials=1)
    assert not bad.stable and bad.summary().startswith("UNSTABLE")
