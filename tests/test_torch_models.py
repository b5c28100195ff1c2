"""The port's particles, crowd and pong models against the JAX package's.

- particles: at the frame a burst spawns, the spawned values, slots, ids,
  ``ttl``, ``alive`` and ``rng_counter`` are bit-equal to the JAX step's;
  integrated float states are held at ``atol=1e-4, rtol=0`` (XLA contracts
  FMAs on the CPU); the lane axis equals solo runs with no ``vmap``
  fallback (``tests/test_batched_lobbies.py::test_batched_lobbies_with_spawns``,
  on particles); the world and its uint32 resource carry across
  (``convert.py``).
- crowd: mirrors of ``tests/test_crowd.py`` (2); one step from equal
  states against the JAX step within ``atol=1e-5`` (float sums in each
  library's own order: the flocking feedback amplifies a last-bit
  difference over a run, so the packages are compared one step at a time),
  integers exact; the lane axis against solo, bit for bit.
- pong: mirrors of ``tests/test_pong.py`` (2); a 650-frame game against
  the JAX package's (integers exact: scores, kinds, alive, ids; floats at
  ``atol=1e-4``); the lane axis at clocks past I32_MAX.
- ``StepCtx.rng_key`` read by a step: equal to the JAX step's draws on the
  solo path, and lane by lane under ``vmap`` on the lane path."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bevy_ggrs_tpu.ops.batch as JB
import bevy_ggrs_tpu_torch.ops.batch as TB
from bevy_ggrs_tpu import App as JApp
from bevy_ggrs_tpu.models import crowd as j_crowd
from bevy_ggrs_tpu.models import particles as j_particles
from bevy_ggrs_tpu.models import pong as j_pong
from bevy_ggrs_tpu_torch import App, GgrsRunner, SyncTestSession
from bevy_ggrs_tpu_torch.convert import world_from_numpy, world_to_numpy
from bevy_ggrs_tpu_torch.models import crowd, particles, pong
from bevy_ggrs_tpu_torch.models.box_game import keys_to_input
from bevy_ggrs_tpu_torch.ops import resim as R
from bevy_ggrs_tpu_torch.snapshot import active_mask
from bevy_ggrs_tpu_torch.utils import threefry
from bevy_ggrs_tpu_torch.utils.tree import tree_flatten

FLOAT_ATOL = 1e-4
CROWD_STEP_ATOL = 1e-5  # one step from equal states: float sums in another order


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def jax_leaves(w) -> dict:
    return {f.name: jax.tree.map(np.asarray, getattr(w, f.name))
            for f in dataclasses.fields(w)}


def assert_like_jax(port_world, jax_world, atol=FLOAT_ATOL):
    """Integers and masks exact, floats within ``atol``."""
    got, want = world_to_numpy(port_world), jax_leaves(jax_world)
    for field in ("comps", "res"):
        for n in want[field]:
            a, b = np.asarray(got[field][n]), np.asarray(want[field][n])
            assert a.dtype == b.dtype and a.shape == b.shape, (field, n)
            if a.dtype.kind == "f":
                np.testing.assert_allclose(a, b, rtol=0, atol=atol, err_msg=n)
            else:
                assert np.array_equal(a, b), (field, n)
    for field in ("has", "res_present"):
        for n in want[field]:
            assert np.array_equal(got[field][n], want[field][n]), (field, n)
    for f in ("alive", "rollback_id", "despawn_pending", "despawn_frame", "next_id",
              "overflow"):
        assert np.array_equal(got[f], want[f]), f


def assert_worlds_equal(a, b):
    for x, y in zip(tree_flatten(a), tree_flatten(b)):
        assert torch.equal(x, y)


def script(k, players=2, seed=1, hi=16):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, hi, (k, players)).astype(np.uint8),
            np.zeros((k, players), np.int8))


# -- particles ---------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 9])
def test_particles_spawn_frame_bit_equal_to_jax(seed):
    """Frame by frame from the same world: the burst's values, slots and
    ids, ``ttl``, ``alive`` and ``rng_counter`` are the JAX step's bits;
    the rows that were already alive integrate within ``atol``."""
    kw = dict(rate=5, ttl=4, seed=seed)  # capacity 124: slots reused from frame 21
    japp, tapp = j_particles.make_app(**kw), particles.make_app(device="cpu", **kw)
    frames = 30
    inputs, status = script(frames)
    jw, tw = japp.init_state(), tapp.init_state()
    for f in range(frames):
        tw_next, _, _ = tapp.resim_fn(tw, inputs[f:f + 1], status[f:f + 1], f)
        jw_next, _, _ = japp.resim_fn(jw, inputs[f:f + 1], status[f:f + 1], f)
        assert_like_jax(tw_next, jw_next)
        got, want = world_to_numpy(tw_next), jax_leaves(jw_next)
        born = want["rollback_id"] >= int(jw.next_id)  # this frame's burst
        assert born.sum() == 5
        for n in ("pos", "vel", "ttl"):
            assert np.array_equal(got["comps"][n][born].view(np.uint32),
                                  want["comps"][n][born].view(np.uint32)), (f, n)
        assert int(got["res"]["rng_counter"]) == f + 1
        assert got["res"]["rng_counter"].dtype == np.uint32
        # continue both from the JAX world: every frame is held from equal states
        tw = world_from_numpy(tapp.reg, want, "cpu")
        jw = jw_next
    assert int(tw.next_id) == frames * 5 and bool(tw.overflow) is False
    assert int(tw.rollback_id.max()) >= 124  # ids past the capacity: slots reused


def test_particles_resim_and_checksums_within_the_float_gap():
    """A 24-frame resim (bursts, expiries, slot reuse): integers exact,
    floats within ``atol``; the checksum of a world carried across from
    JAX equals JAX's."""
    kw = dict(rate=3, ttl=5, capacity=40)
    japp, tapp = j_particles.make_app(**kw), particles.make_app(device="cpu", **kw)
    inputs, status = script(24)
    jf, jstack, _ = japp.resim_fn(japp.init_state(), inputs, status, 0)
    tf, tstack, tchecks = tapp.resim_fn(tapp.init_state(), inputs, status, 0)
    assert_like_jax(tf, jf)
    carried = world_from_numpy(tapp.reg, jax_leaves(jf), "cpu")
    want = int(np.asarray(japp.checksum_fn(jf)).astype(np.uint64) @ np.array(
        [1 << 32, 1], np.uint64))
    from bevy_ggrs_tpu_torch.snapshot import checksum_to_int

    assert checksum_to_int(tapp.checksum_fn(carried)) == want
    assert tchecks.shape == (24, 2)


def test_batched_lobbies_with_spawns_particles():
    """``tests/test_batched_lobbies.py::test_batched_lobbies_with_spawns``
    on the port: particles lobbies at their own clocks in one wave, each
    lane bit-equal to its solo run, no ``vmap`` fallback; the integers
    equal the JAX wave's."""
    m, k = 3, 4
    app = particles.make_app(rate=4, ttl=8, capacity=128, device="cpu")
    japp = j_particles.make_app(rate=4, ttl=8, capacity=128)
    rng = np.random.default_rng(3)
    inputs = rng.integers(0, 8, (m, k, 2)).astype(np.uint8)
    status = np.zeros((m, k, 2), np.int8)
    starts = np.array([0, 5, 31], np.int32)
    worlds = [app.init_state() for _ in range(m)]
    R.vmap_fallbacks = 0
    finals, _, checks = TB.make_batched_resim_fn(app)(
        TB.stack_worlds(worlds), inputs, status, starts)
    assert R.vmap_fallbacks == 0
    for b in range(m):
        one, _, one_checks = app.resim_fn(worlds[b], inputs[b], status[b], int(starts[b]))
        assert torch.equal(one_checks, checks[b])
        assert_worlds_equal(TB.unstack_world(finals, b), one)
    jf, _, _ = JB.make_batched_resim_fn(japp)(
        JB.stack_worlds([japp.init_state() for _ in range(m)]), inputs, status, starts)
    assert_like_jax(finals, jf)


def test_particles_world_carries_across_both_ways():
    japp = j_particles.make_app(rate=2, ttl=3, capacity=16)
    tapp = particles.make_app(rate=2, ttl=3, capacity=16, device="cpu")
    inputs, status = script(5)
    jf, _, _ = japp.resim_fn(japp.init_state(), inputs, status, 0)
    tw = world_from_numpy(tapp.reg, jax_leaves(jf), "cpu")
    assert tw.res["rng_counter"].dtype == torch.uint32 and int(tw.res["rng_counter"]) == 5
    back = world_to_numpy(tw)
    for x, y in zip(jax.tree.leaves(back), jax.tree.leaves(jax_leaves(jf))):
        assert x.dtype == y.dtype and np.array_equal(x, y)


def test_particles_quantized_synctest_clean():
    app = particles.make_app(rate=4, ttl=6, capacity=64, quantize=True, device="cpu")
    session = SyncTestSession(num_players=2, input_shape=(), input_dtype=np.uint8,
                              check_distance=3)
    mismatches = []
    runner = GgrsRunner(app, session, on_mismatch=mismatches.append)
    for _ in range(20):
        runner.tick()
    assert mismatches == [] and runner.world.comps["pos"].dtype == torch.float32


# -- StepCtx.rng_key read by a step ------------------------------------------------


def _keyed_app(pkg, seed):
    """A step that draws from ``ctx.rng_key`` every frame: the sum of the
    frame's bits, in a uint32 resource (wrapping) and an int32 column."""
    if pkg == "jax":
        a = JApp(num_players=2, capacity=4, input_shape=(), input_dtype=np.uint8, seed=seed)
        a.rollback_component("v", (), jnp.float32, checksum=True)
        a.rollback_resource("acc", jnp.uint32(0), checksum=True)

        def step(w, ctx):
            u = jax.random.uniform(ctx.rng_key, (4,), jnp.float32, -2.0, 2.0)
            bits = jax.random.bits(ctx.rng_key, (3,), jnp.uint32)
            return dataclasses.replace(w, comps={"v": w.comps["v"] + u},
                                       res={"acc": w.res["acc"] + bits.sum()})
    else:
        a = App(num_players=2, capacity=4, input_shape=(), input_dtype=np.uint8, seed=seed,
                device="cpu")
        a.rollback_component("v", (), torch.float32, checksum=True)
        a.rollback_resource("acc", np.uint32(0), checksum=True)

        def step(w, ctx):
            dev = w.device
            u = threefry.uniform(ctx.rng_key, (4,), -2.0, 2.0, device=dev)
            total = threefry.random_bits(ctx.rng_key, (3,), device=dev).sum()
            acc = (w.res["acc"].view(torch.int32).to(torch.int64) + total) & 0xFFFFFFFF
            acc = acc.to(torch.int32).view(torch.uint32)  # wraps as u32
            return dataclasses.replace(w, comps={"v": w.comps["v"] + u},
                                       res={"acc": acc})
    a.set_step(step)
    return a


def test_rng_key_step_solo_and_lanes():
    japp, tapp = _keyed_app("jax", 7), _keyed_app("torch", 7)
    inputs, status = script(6)
    for start in (0, 2**31 - 3):
        jf, _, _ = japp.resim_fn(japp.init_state(), inputs, status, start)
        tf, _, _ = tapp.resim_fn(tapp.init_state(), inputs, status, start)
        assert np.array_equal(world_to_numpy(tf)["comps"]["v"], np.asarray(jf.comps["v"]))
        assert int(tf.res["acc"]) == int(jf.res["acc"])
    starts = np.array([0, 11, 2**31 - 3], np.int32)
    m = len(starts)
    worlds = [tapp.init_state() for _ in range(m)]
    ib = np.stack([inputs] * m)
    sb = np.stack([status] * m)
    R.vmap_fallbacks = 0
    finals, _, checks = TB.make_batched_resim_fn(tapp)(TB.stack_worlds(worlds), ib, sb, starts)
    assert R.vmap_fallbacks == 0
    for b in range(m):
        one, _, one_checks = tapp.resim_fn(worlds[b], inputs, status, int(starts[b]))
        assert torch.equal(one_checks, checks[b])
        assert_worlds_equal(TB.unstack_world(finals, b), one)


# -- crowd (tests/test_crowd.py) ---------------------------------------------------


def test_crowd_synctest_clean():
    app = crowd.make_app(n_per_team=64, num_teams=2, device="cpu")
    session = SyncTestSession(num_players=2, input_shape=(), input_dtype=np.uint8,
                              check_distance=3)
    mismatches = []
    runner = GgrsRunner(
        app, session,
        read_inputs=lambda hs: {h: keys_to_input(right=(h == 0)) for h in hs},
        on_mismatch=mismatches.append,
    )
    for _ in range(20):
        runner.tick()
    assert mismatches == []
    pos = runner.world.comps["pos"].numpy()
    team = runner.world.comps["team"].numpy()
    assert pos[team == 0, 0].mean() > pos[team == 1, 0].mean()


def test_crowd_flocks_toward_centroid():
    app = crowd.make_app(n_per_team=64, num_teams=2, device="cpu")
    session = SyncTestSession(num_players=2, input_shape=(), input_dtype=np.uint8,
                              check_distance=0)
    runner = GgrsRunner(app, session)
    spread0 = runner.world.comps["pos"].numpy().std()
    for _ in range(60):
        runner.tick()
    spread1 = runner.world.comps["pos"].numpy()[runner.world.alive.numpy()].std()
    assert spread1 < spread0


def test_crowd_one_step_from_equal_states_against_jax():
    """Setup equal bit for bit (the same host draws); then each step from
    the JAX world: positions and velocities within ``atol=1e-5``, teams,
    masks and ids exact."""
    japp = j_crowd.make_app(n_per_team=48, num_teams=3)
    tapp = crowd.make_app(n_per_team=48, num_teams=3, device="cpu")
    jw = japp.init_state()
    got, want = world_to_numpy(tapp.init_state()), jax_leaves(jw)
    for n in ("pos", "vel", "team"):
        assert np.array_equal(got["comps"][n], want["comps"][n]), n
    inputs, status = script(12, players=3)
    for f in range(12):
        tw = world_from_numpy(tapp.reg, jax_leaves(jw), "cpu")
        tf, _, _ = tapp.resim_fn(tw, inputs[f:f + 1], status[f:f + 1], f)
        jw, _, _ = japp.resim_fn(jw, inputs[f:f + 1], status[f:f + 1], f)
        assert_like_jax(tf, jw, atol=CROWD_STEP_ATOL)


def test_crowd_lanes_equal_solo():
    app = crowd.make_app(n_per_team=32, num_teams=2, device="cpu")
    m, k = 4, 5
    rng = np.random.default_rng(5)
    inputs = rng.integers(0, 16, (m, k, 2)).astype(np.uint8)
    status = np.zeros((m, k, 2), np.int8)
    starts = np.array([0, 3, 40, 2**31 - 2], np.int32)
    worlds = [app.init_state() for _ in range(m)]
    R.vmap_fallbacks = 0
    finals, _, checks = TB.make_batched_resim_fn(app)(
        TB.stack_worlds(worlds), inputs, status, starts)
    assert R.vmap_fallbacks == 0
    for b in range(m):
        one, _, one_checks = app.resim_fn(worlds[b], inputs[b], status[b], int(starts[b]))
        assert torch.equal(one_checks, checks[b])
        assert_worlds_equal(TB.unstack_world(finals, b), one)


# -- pong (tests/test_pong.py) -------------------------------------------------------


def run_game(ticks, check_distance=3, p0_move=0, p1_move=0):
    app = pong.make_app(device="cpu")
    session = SyncTestSession(num_players=2, input_shape=(), input_dtype=np.uint8,
                              check_distance=check_distance)
    mismatches = []
    runner = GgrsRunner(
        app, session,
        read_inputs=lambda hs: {0: np.uint8(p0_move), 1: np.uint8(p1_move)},
        on_mismatch=mismatches.append,
    )
    for _ in range(ticks):
        runner.tick()
    return runner, mismatches


def test_rally_scores_and_reserves():
    runner, mismatches = run_game(650, p1_move=pong.UP)
    assert mismatches == []
    score = runner.world.res["score"].numpy()
    assert score.sum() >= 1, f"no goals after 650 frames: {score}"
    kind = runner.world.comps["kind"].numpy()
    active = active_mask(runner.world).numpy()
    assert (active & (kind == pong.K_BALL)).sum() <= 1
    assert int(runner.world.next_id) >= 3
    # the same game on the JAX package (its resim of the 650 frames; a
    # SyncTest replays the same inputs): integers exact, floats within atol
    japp = j_pong.make_app()
    inputs = np.tile(np.array([[0, pong.UP]], np.uint8), (650, 1))
    jf, _, _ = japp.resim_fn(japp.init_state(), inputs, np.zeros((650, 2), np.int8), 0)
    assert_like_jax(runner.world, jf)


def test_paddles_track_input():
    runner, mismatches = run_game(30, p0_move=pong.UP, p1_move=pong.DOWN)
    assert mismatches == []
    pos = runner.world.comps["pos"].numpy()
    assert pos[0, 1] > 0.3
    assert pos[1, 1] < -0.3


def test_pong_lanes_at_wrapping_clocks_equal_solo():
    """The serve compares ``ctx.frame`` on the device: lanes at their own
    clocks, two past I32_MAX, equal their solo runs, which compare a host
    frame."""
    app = pong.make_app(device="cpu")
    m, k = 3, 60
    inputs = np.zeros((m, k, 2), np.uint8)
    inputs[:, :, 1] = pong.UP
    status = np.zeros((m, k, 2), np.int8)
    starts = np.array([0, 2**31 - 30, -(2**31) + 5], np.int32)
    world = app.init_state()
    world = dataclasses.replace(world, res={**world.res, "serve_at": torch.tensor(
        0, dtype=torch.int32)})
    worlds = []
    for s in starts:  # each lobby serves 10 frames after its own start
        serve = np.int32(((int(s) + 10 + 2**31) % 2**32) - 2**31)
        worlds.append(dataclasses.replace(world, res={**world.res, "serve_at":
                                                      torch.tensor(serve)}))
    R.vmap_fallbacks = 0
    finals, _, checks = TB.make_batched_resim_fn(app)(
        TB.stack_worlds(worlds), inputs, status, starts)
    assert R.vmap_fallbacks == 0
    for b in range(m):
        one, _, one_checks = app.resim_fn(worlds[b], inputs[b], status[b], int(starts[b]))
        assert torch.equal(one_checks, checks[b])
        assert_worlds_equal(TB.unstack_world(finals, b), one)
        assert int(one.next_id) == 3  # the ball was served at its lane's frame
