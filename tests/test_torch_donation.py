"""The port's donating resim and the runner's donation decision, on the CPU.

Mirrors tests/test_donation.py where a case applies to a solo runner: the
donating resim is bit-identical to the plain one and consumes its input
(the passed world object is dead: the armed sanitizer refuses to dispatch
it again; no storage is written in place), and the runner's checksum
stream is the same with and without donation while SyncTest rolls back
every tick (load, leading save of the donated world, donated resim).  A
step that spawns at one host-chosen frame, under SyncTest and a rolling-
back P2P pair, leaves every ring entry equal to what was saved.  On
fixed_point the donating runner equals the JAX runner with
``pipeline=False`` bit for bit.  The ring's memory guard
(``ring_materialize_bytes``) changes no checksum."""

import dataclasses

import numpy as np
import pytest
import torch

from bevy_ggrs_tpu import GgrsRunner as JRunner
from bevy_ggrs_tpu import SyncTestSession as JSession
from bevy_ggrs_tpu.models import fixed_point as j_fixed_point
from bevy_ggrs_tpu_torch import App, GgrsRunner, PlayerType, SessionBuilder, SessionState
from bevy_ggrs_tpu_torch import SyncTestSession
from bevy_ggrs_tpu_torch.models import box_game, fixed_point, stress
from bevy_ggrs_tpu_torch.ops.packing import PackedUpload, pack_prefix, pack_row, prefix_words
from bevy_ggrs_tpu_torch.session.channel import ChannelNetwork
from bevy_ggrs_tpu_torch.session.events import InputStatus
from bevy_ggrs_tpu_torch.snapshot.lazy import LazySlice, tree_index, wrap_single_checksum
from bevy_ggrs_tpu_torch.snapshot.world import active_mask, spawn
from bevy_ggrs_tpu_torch.utils import staging
from bevy_ggrs_tpu_torch.utils.staging import TransferRaceError
from bevy_ggrs_tpu_torch.utils.tree import tree_leaves


def run_synctest(app, enable_donation=True, ticks=40, check_distance=4,
               jax_runner=False, **kw):
    rng = np.random.default_rng(11)
    cls, sess = (JRunner, JSession) if jax_runner else (GgrsRunner, SyncTestSession)
    runner = cls(app, sess(num_players=2, input_shape=(), input_dtype=np.uint8,
                           check_distance=check_distance, compare_interval=1),
                 read_inputs=lambda hs: {h: np.uint8(rng.integers(0, 16)) for h in hs},
                 on_mismatch=lambda e: (_ for _ in ()).throw(e), **kw)
    runner.enable_donation = enable_donation
    checks = []
    for _ in range(ticks):
        runner.tick()
        checks.append(runner.checksum)
    runner.finish()
    return runner, checks


def leaves_equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))


def test_donated_op_bit_identical_to_plain():
    app = stress.make_app(512, device="cpu")
    inputs = np.zeros((8, 2), np.uint8)
    status = np.full((8, 2), InputStatus.CONFIRMED, np.int8)
    f1, s1, c1 = app.resim_fn(app.init_state(), inputs, status, 0)
    f2, s2, c2 = app.resim_fn_donated(app.init_state(), inputs, status, 0)
    assert torch.equal(c1, c2)
    assert leaves_equal(f1, f2) and leaves_equal(s1, s2)


def test_donated_packed_op_bit_identical_to_plain():
    app = fixed_point.make_app(device="cpu")
    spec = app.packed_spec
    buf = spec.new_buffer(5)
    pack_prefix(buf, 3, 5)
    for i in range(5):
        pack_row(spec, buf, i, np.array([i, 7 - i], np.uint8), np.zeros(2, np.int8))
    packed = PackedUpload(torch.from_numpy(buf), *prefix_words(buf))
    f1, _, c1 = app.packed_resim_fn(app.init_state(), packed)
    f2, _, c2 = app.packed_resim_fn_donated(app.init_state(), packed)
    f3, _, c3 = app.resim_fn(app.init_state(), buf[1:, :2].view(np.uint8),
                             buf[1:, 2:4], 3)
    assert torch.equal(c1, c2) and torch.equal(c1, c3)
    assert leaves_equal(f1, f2) and leaves_equal(f1, f3)


def test_donation_consumes_input_state():
    """The donated input object is dead: the armed sanitizer refuses a
    second dispatch of it, the returned world is a new object, and the
    input's storage was not written (a snapshot sharing it stays valid)."""
    app = stress.make_app(128, device="cpu")
    inputs = np.zeros((4, 2), np.uint8)
    status = np.full((4, 2), InputStatus.CONFIRMED, np.int8)
    san = staging.set_sanitize(True)
    try:
        w = app.init_state()
        before = [a.clone() for a in tree_leaves(w)]
        final, stacked, _ = app.resim_fn_donated(w, inputs, status, 0)
        assert final is not w
        assert leaves_equal(final, tree_index(stacked, 3))
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(w), before))
        with pytest.raises(TransferRaceError):
            app.resim_fn(w, inputs, status, 0)
        assert san.violations_by_rule == {"donated_reuse": 1}
        app.resim_fn(final, inputs, status, 4)  # the returned world is live
    finally:
        staging.set_sanitize(False)


def test_canonical_apps_have_no_donating_program():
    app = stress.make_app(64, canonical_depth=8, device="cpu")
    assert app.resim_fn_donated is None and app.packed_resim_fn_donated is None
    runner, _ = run_synctest(app, ticks=12)
    assert runner.stats()["donated_dispatches"] == 0


def test_runner_checksums_identical_with_and_without_donation():
    # SyncTest rolls back check_distance frames every tick, so this drives
    # the load + leading-save + donated-resim cycle continuously
    on, with_donation = run_synctest(stress.make_app(256, device="cpu"), True)
    off, without = run_synctest(stress.make_app(256, device="cpu"), False)
    assert with_donation == without
    assert on.donated_dispatches > 0 and off.donated_dispatches == 0


@pytest.mark.parametrize("kw", [{}, {"packed": False}, {"pipeline": False}],
                         ids=["pipelined_packed", "unpacked", "sync"])
def test_runner_donation_fixed_point_equals_jax_sync_runner(kw):
    runner, port = run_synctest(fixed_point.make_app(device="cpu"), True, ticks=30,
                              check_distance=5, **kw)
    _, jax_sync = run_synctest(j_fixed_point.make_app(), True, ticks=30, check_distance=5,
                             jax_runner=True, pipeline=False)
    assert port == jax_sync
    assert runner.donated_dispatches > 0


def test_ring_memory_guard_materializes_saves_and_changes_no_checksum():
    guarded, a = run_synctest(stress.make_app(256, device="cpu"), ticks=30)
    lazy = [s for s, _ in guarded.ring._snapshots if isinstance(s, LazySlice)]
    assert guarded.materialized_saves == 0 and lazy

    app = stress.make_app(256, device="cpu")
    rng = np.random.default_rng(11)
    small = GgrsRunner(app, SyncTestSession(num_players=2, check_distance=4),
                       read_inputs=lambda hs: {h: np.uint8(rng.integers(0, 16)) for h in hs},
                       on_mismatch=lambda e: (_ for _ in ()).throw(e))
    one_world = sum(a.numel() * a.element_size() for a in tree_leaves(small.world))
    small.ring_materialize_bytes = 2 * one_world  # k >= 3 stacks materialize
    b = []
    for _ in range(30):
        small.tick()
        b.append(small.checksum)
    small.finish()
    assert a == b
    st = small.stats()
    assert st["materialized_saves"] > 0
    # each tick ends with a k=4 rollback run, above the guard: its saves
    # were cloned, so no ring entry (and no load) reads its stacked output
    assert small._last_stacked is None and guarded._last_stacked is not None
    assert st["donated_dispatches"] > 0


def test_donation_p2p_under_latency():
    """A P2P pair over a 3-hop channel with flipping inputs: real
    rollbacks while the donating path is active, and the rings agree."""
    net = ChannelNetwork(latency_hops=3, seed=3)
    socks = [net.endpoint("d0"), net.endpoint("d1")]
    runners = []
    for i in range(2):
        app = box_game.make_app(num_players=2, device="cpu")
        session = (SessionBuilder.for_app(app).with_input_delay(1)
                   .add_player(PlayerType.LOCAL, i)
                   .add_player(PlayerType.REMOTE, 1 - i, f"d{1 - i}")
                   .start_p2p_session(socks[i]))

        def read_inputs(handles, i=i):
            key = {0: "right", 1: "down"}[i]
            return {h: box_game.keys_to_input(**{key: True}) for h in handles}

        r = GgrsRunner(app, session, read_inputs=read_inputs)
        assert r.enable_donation  # the default: this test exists to cover it
        runners.append(r)

    def drive(ticks, dt=1.0 / 60.0):
        for _ in range(ticks):
            net.deliver()
            for r in runners:
                r.update(dt)

    drive(300, dt=0.0)
    assert all(r.session.current_state() == SessionState.RUNNING for r in runners)
    flip = [0]

    def flipping(handles):
        flip[0] += 1
        return {h: box_game.keys_to_input(right=(flip[0] // 5) % 2 == 0) for h in handles}

    runners[0].read_inputs = flipping
    drive(120)
    assert all(r.donated_dispatches > 0 for r in runners)
    assert all(r.rollbacks > 0 for r in runners)
    assert all(r.frame >= 100 for r in runners)
    shared = []
    for _ in range(6):
        shared = sorted(set(runners[0].ring.frames()) & set(runners[1].ring.frames()))
        if shared:
            break
        drive(1)
    assert shared
    f = shared[-1]
    assert runners[0].ring.peek(f)[1]() == runners[1].ring.peek(f)[1]()


# -- a step that spawns at one host-chosen frame --------------------------------

# frame 2 follows the first run, which never donates (the caller may hold
# the initial world); frame 40 lies among the pair's rollbacks
SPAWN_FRAMES = [2, 40]


def make_spawn_app(spawn_at: int):
    """Two players; one entity whose ``pos`` sums the inputs and whose
    ``tag`` no step touches, and a second entity spawned when the host-side
    ``ctx.frame`` reaches ``spawn_at``.  Only that frame replaces ``tag``
    and ``next_id``; every other step passes them through, so a world
    shares them with the snapshots saved before it."""
    app = App(num_players=2, capacity=4, input_shape=(), input_dtype=np.uint8,
              device="cpu")
    app.rollback_component("pos", (), torch.int32, checksum=True)
    app.rollback_component("tag", (), torch.int32, checksum=True)

    def step(world, ctx):
        if ctx.frame == spawn_at:
            world, _ = spawn(app.reg, world, {"pos": 1000, "tag": 7})
        pos = world.comps["pos"]
        pos = torch.where(active_mask(world), pos + ctx.inputs.to(torch.int32).sum(), pos)
        return dataclasses.replace(world, comps={**world.comps, "pos": pos})

    app.set_step(step)
    app.set_setup(lambda w: spawn(app.reg, w, {"pos": 0, "tag": 1})[0])
    return app


def ring_entries(runner) -> dict:
    """``frame -> (leaves, checksum)`` of every ring entry; each entry's
    state must still hash to the checksum saved with it."""
    out = {}
    for f in runner.ring.frames():
        stored, cs = runner.ring.peek(f)
        if isinstance(stored, LazySlice):
            stored = tree_index(stored._stacked, stored._i)
        value = cs()
        assert wrap_single_checksum(runner.app.checksum_fn(stored))() == value, f
        out[f] = ([a.clone() for a in tree_leaves(stored)], value)
    return out


def assert_rings_equal(a: dict, b: dict, frames) -> None:
    for f in frames:
        (la, ca), (lb, cb) = a[f], b[f]
        assert ca == cb and all(torch.equal(x, y) for x, y in zip(la, lb)), f


@pytest.mark.parametrize("spawn_at", SPAWN_FRAMES)
def test_spawn_at_host_frame_synctest_donation_on_off_equal(spawn_at):
    runs = {}
    for donation in (True, False):
        app = make_spawn_app(spawn_at)
        rng = np.random.default_rng(11)
        runner = GgrsRunner(
            app, SyncTestSession(num_players=2, input_shape=(), input_dtype=np.uint8,
                                 check_distance=4, compare_interval=1),
            read_inputs=lambda hs: {h: np.uint8(rng.integers(0, 16)) for h in hs},
            on_mismatch=lambda e: (_ for _ in ()).throw(e))
        runner.enable_donation = donation
        stream, rings = [], {}
        for _ in range(spawn_at + 12):
            runner.tick()
            stream.append(runner.checksum)
            rings.update(ring_entries(runner))
        runner.finish()
        assert (runner.donated_dispatches > 0) == donation
        assert int(runner.world.alive.sum()) == 2
        runs[donation] = (stream, rings)
    assert runs[True][0] == runs[False][0]
    assert sorted(runs[True][1]) == sorted(runs[False][1])
    assert_rings_equal(runs[True][1], runs[False][1], runs[True][1])


def spawn_pair(spawn_at: int, donation: bool):
    """A rolling-back pair of spawn apps; returns the runners, each
    runner's confirmed ``frame -> checksum`` and ring entries taken every
    tick around the spawn frame."""
    net = ChannelNetwork(latency_hops=3, seed=5)
    socks = [net.endpoint("s0"), net.endpoint("s1")]
    runners, confirmed = [], [{}, {}]
    for i in range(2):
        app = make_spawn_app(spawn_at)
        session = (SessionBuilder.for_app(app).with_input_delay(1)
                   .add_player(PlayerType.LOCAL, i)
                   .add_player(PlayerType.REMOTE, 1 - i, f"s{1 - i}")
                   .start_p2p_session(socks[i]))

        def read_inputs(handles, i=i):
            frame = runners[i].frame
            return {h: np.uint8((frame // 5) % 2 if i == 0 else 1) for h in handles}

        r = GgrsRunner(app, session, read_inputs=read_inputs)
        r.enable_donation = donation

        def on_confirmed(frame, r=r, seen=confirmed[i]):
            entry = r.ring.peek(frame)
            if entry is not None:
                seen.setdefault(frame, entry[1])

        r.on_confirmed = on_confirmed
        runners.append(r)
    for _ in range(300):
        net.deliver()
        for r in runners:
            r.update(0.0)
        if all(r.session.current_state() == SessionState.RUNNING for r in runners):
            break
    assert all(r.session.current_state() == SessionState.RUNNING for r in runners)
    rings = [{}, {}]
    for _ in range(spawn_at + 30):
        net.deliver()
        for i, r in enumerate(runners):
            r.update(1.0 / 60.0)
            if abs(r.frame - spawn_at) <= 10:
                rings[i].update(ring_entries(r))
    for r in runners:
        r.finish()
    return runners, [{f: cs() for f, cs in seen.items()} for seen in confirmed], rings


@pytest.mark.parametrize("spawn_at", SPAWN_FRAMES)
def test_spawn_at_host_frame_p2p_donation_on_off_equal(spawn_at):
    on_runners, on_confirmed, on_rings = spawn_pair(spawn_at, True)
    off_runners, off_confirmed, off_rings = spawn_pair(spawn_at, False)
    for runners in (on_runners, off_runners):
        assert all(r.rollbacks > 0 and r.frame > spawn_at + 10 for r in runners)
        assert all(int(r.world.alive.sum()) == 2 for r in runners)
        assert not any(type(e).__name__ == "DesyncDetected" for r in runners for e in r.events)
    assert all(r.donated_dispatches > 0 for r in on_runners)
    assert all(r.donated_dispatches == 0 for r in off_runners)
    for on, off in zip(on_confirmed, off_confirmed):
        shared = set(on) & set(off)
        assert len(shared) > spawn_at + 10 and all(on[f] == off[f] for f in shared)
    # the confirmed frames around the spawn, as both rings held them
    for on, off, runner in zip(on_rings, off_rings, on_runners):
        frames = [f for f in set(on) & set(off) if f <= runner.confirmed]
        assert any(f >= spawn_at for f in frames)
        assert_rings_equal(on, off, frames)
