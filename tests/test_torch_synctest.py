"""The PyTorch port's SyncTest session, snapshot ring and runner.

Mirrors tests/test_synctest.py, tests/test_ring.py and
examples/box_game_synctest.py against the port on the CPU.  The port's own
SyncTest of box_game and fixed_point must run with no mismatch at every
check distance from 2 to 7, and for fixed_point its checksum stream must
equal the JAX runner's exactly, frame by frame."""

import dataclasses

import numpy as np
import pytest
import torch

from bevy_ggrs_tpu import GgrsRunner as JRunner
from bevy_ggrs_tpu import SyncTestSession as JSession
from bevy_ggrs_tpu.models import fixed_point as j_fixed_point
from bevy_ggrs_tpu_torch import App, GgrsRunner, PlayerType, SessionBuilder, SyncTestSession
from bevy_ggrs_tpu_torch.models import box_game, fixed_point
from bevy_ggrs_tpu_torch.session.channel import ChannelNetwork
from bevy_ggrs_tpu_torch.snapshot import (
    MissingSnapshotError,
    SnapshotRing,
    Strategy,
    active_count,
    active_mask,
    checksum_to_int,
    despawn_where,
    rollback_many,
    spawn,
)
from bevy_ggrs_tpu_torch.utils.frames import I32_MAX, I32_MIN, wrap_i32


def flipping_inputs(holder):
    """Inputs that flip every 5 frames, different per player (a constant
    input would never exercise a rollback's corrected resim)."""
    def read_inputs(handles):
        phase = (holder[0].frame // 5) % 4
        return {h: np.uint8(1 << ((phase + h) % 4)) for h in handles}
    return read_inputs


def run_port(app, check_distance, frames):
    holder = []
    session = (SessionBuilder.for_app(app).with_check_distance(check_distance)
               .start_synctest_session())
    runner = GgrsRunner(app, session, read_inputs=flipping_inputs(holder))
    holder.append(runner)
    stream = []
    for _ in range(frames):
        runner.tick()
        stream.append(runner.checksum)
    runner.finish()
    return runner, stream


@pytest.mark.parametrize("check_distance", range(2, 8))
def test_fixed_point_stream_equals_jax_runner(check_distance):
    frames = 24
    runner, stream = run_port(fixed_point.make_app(device="cpu"), check_distance, frames)
    assert runner.rollbacks == frames - check_distance + 1
    holder = []
    japp = j_fixed_point.make_app()
    jrunner = JRunner(japp, JSession(num_players=2, check_distance=check_distance),
                      read_inputs=flipping_inputs(holder))
    holder.append(jrunner)
    jstream = []
    for _ in range(frames):
        jrunner.tick()
        jstream.append(jrunner.checksum)
    jrunner.finish()
    assert stream == jstream


@pytest.mark.parametrize("check_distance", range(2, 8))
def test_box_game_synctest_no_mismatch(check_distance):
    runner, _ = run_port(box_game.make_app(device="cpu"), check_distance, 40)
    assert runner.frame == 40
    assert runner.rollbacks > 0
    assert runner.session.pending_comparisons() == 0


def test_canonical_depth_gives_the_same_stream():
    """An app configured like the JAX package's canonical mode (one padded
    resim length for every advance) checksums the same frames alike."""
    _, plain = run_port(fixed_point.make_app(device="cpu"), 5, 20)
    app = fixed_point.make_app(device="cpu")
    app.canonical_depth = 8
    _, canonical = run_port(app, 5, 20)
    assert canonical == plain


def test_lossy_store_strategy_round_trips_every_frame():
    """A store strategy that narrows the saved columns to bfloat16 makes the
    stored form canonical: live and resimulated frames still agree."""
    app = App(num_players=2, capacity=4, device="cpu")
    bf16 = Strategy(store=lambda a: a.to(torch.bfloat16), load=lambda a: a)
    app.rollback_component("pos", (2,), torch.float32, checksum=True, strategy=bf16)
    app.rollback_component("vel", (2,), torch.float32, checksum=True)
    app.rollback_component("handle", (), torch.int32, checksum=True)
    app.set_step(box_game.step)
    app.set_setup(box_game.setup(app))
    runner, _ = run_port(app, 4, 30)
    assert runner.rollbacks > 0
    pos = runner.world.comps["pos"]
    assert pos.dtype == torch.float32
    assert torch.equal(pos, pos.to(torch.bfloat16).to(torch.float32))


def make_counter_app(despawn_at=None, retention=8):
    app = App(num_players=1, capacity=4, retention=retention, device="cpu")
    app.rollback_component("counter", (), torch.int32, checksum=True)

    def step(world, ctx):
        mask = active_mask(world) & world.has["counter"]
        cnt = torch.where(mask, world.comps["counter"] + 1, world.comps["counter"])
        world = dataclasses.replace(world, comps={**world.comps, "counter": cnt})
        if despawn_at is not None:
            world = despawn_where(app.reg, world, mask & (ctx.frame == despawn_at),
                                  ctx.frame)
        return world

    app.set_step(step)
    app.set_setup(lambda w: spawn(app.reg, w, {"counter": 0})[0])
    return app


def make_runner(app, check_distance=2, compare_interval=None):
    session = SyncTestSession(num_players=app.num_players, check_distance=check_distance,
                              compare_interval=compare_interval)
    mismatches = []
    return GgrsRunner(app, session, on_mismatch=mismatches.append), session, mismatches


def inject_divergence(runner):
    """Poke checksummed state behind the session's back."""
    runner.world = dataclasses.replace(
        runner.world,
        comps={**runner.world.comps, "counter": runner.world.comps["counter"] + 1000},
    )
    value = checksum_to_int(runner.app.checksum_fn(runner.world))
    runner._world_checksum = lambda: value


@pytest.mark.parametrize("check_distance", [0, 2, 7])
def test_counter_equals_frame_count(check_distance):
    runner, _, mismatches = make_runner(make_counter_app(), check_distance)
    for _ in range(20):
        runner.tick()
    assert mismatches == []
    assert runner.frame == 20
    assert int(runner.world.comps["counter"][0]) == 20


def test_negative_control_detects_injected_nondeterminism():
    runner, _, mismatches = make_runner(make_counter_app(), 3)
    for _ in range(10):
        runner.tick()
    assert mismatches == []
    inject_divergence(runner)
    for _ in range(6):
        runner.tick()
    assert len(mismatches) >= 1


def test_mismatch_without_handler_raises():
    runner, _, _ = make_runner(make_counter_app(), 3)
    runner.on_mismatch = None
    for _ in range(5):
        runner.tick()
    inject_divergence(runner)
    with pytest.raises(Exception, match="checksum mismatch"):
        for _ in range(6):
            runner.tick()


def test_despawn_across_rollback():
    runner, _, mismatches = make_runner(make_counter_app(despawn_at=10, retention=8), 3)
    for _ in range(15):
        runner.tick()
    assert int(active_count(runner.world)) == 0  # disabled, still allocated
    for _ in range(10):
        runner.tick()
    assert mismatches == []
    assert not bool(runner.world.alive[0])  # hard-freed past despawn + retention


def test_snapshot_pruning_after_confirm():
    runner, _, _ = make_runner(make_counter_app(), 2)
    for _ in range(30):
        runner.tick()
    assert len(runner.ring) <= runner.ring.depth
    assert all(f >= runner.confirmed for f in runner.ring.frames())


def test_non_checksummed_component_still_rolls_back():
    app = App(num_players=1, capacity=4, device="cpu")
    app.rollback_component("cs", (), torch.int32, checksum=True)
    app.rollback_component("plain", (), torch.int32)

    def step(world, ctx):
        m = active_mask(world)
        c = world.comps
        return dataclasses.replace(world, comps={
            "cs": torch.where(m, c["cs"] + 1, c["cs"]),
            "plain": torch.where(m, c["plain"] + 2, c["plain"]),
        })

    app.set_step(step)
    app.set_setup(lambda w: spawn(app.reg, w, {"cs": 0, "plain": 0})[0])
    runner, _, mismatches = make_runner(app, 2)
    for _ in range(12):
        runner.tick()
    assert mismatches == []
    assert runner.read_components(["plain"])["plain"][0] == 24


def test_box_game_moves_player_and_input_delay_shifts_effect():
    app = box_game.make_app(num_players=1, capacity=4, device="cpu")
    session = (SessionBuilder.for_app(app).with_check_distance(0).with_input_delay(5)
               .start_synctest_session())
    runner = GgrsRunner(app, session, read_inputs=lambda hs: {
        h: box_game.keys_to_input(right=True) for h in hs})
    x0 = float(runner.world.comps["pos"][0, 0])
    for _ in range(3):
        runner.tick()
    assert float(runner.world.comps["vel"][0].abs().max()) == 0.0  # delayed
    for _ in range(10):
        runner.tick()
    assert float(runner.world.comps["pos"][0, 0]) > x0


def test_accumulator_and_session_restart():
    runner, _, _ = make_runner(make_counter_app(), 1)
    runner.update(5.5 / 60.0)  # one big host tick -> 5 frames
    assert runner.frame == 5
    runner.set_session(SyncTestSession(num_players=1, check_distance=2))
    assert runner.frame == 0 and len(runner.ring) == 0
    for _ in range(4):
        runner.tick()
    assert runner.frame == 4


def test_compare_interval_follows_the_device():
    _, session, _ = make_runner(make_counter_app(), 2)
    assert session.compare_interval() == 1  # a CPU world compares promptly
    _, session, _ = make_runner(make_counter_app(), 2, compare_interval=16)
    assert session.compare_interval() == 16  # an explicit cadence is kept
    fresh = SyncTestSession(num_players=1)
    fresh.bind_device(torch.device("cuda"))
    assert fresh.compare_interval() == 32


def test_deferred_compare_detects_and_finish_flushes():
    runner, session, mismatches = make_runner(make_counter_app(), 3, compare_interval=8)
    for _ in range(10):
        runner.tick()
    inject_divergence(runner)
    for _ in range(session.compare_interval() + session.check_distance + 2):
        runner.tick()
        if mismatches:
            break
    assert mismatches, "deferred comparison never fired"

    runner, session, mismatches = make_runner(make_counter_app(), 3, compare_interval=64)
    for _ in range(10):
        runner.tick()
    inject_divergence(runner)
    for _ in range(session.check_distance + 1):
        runner.tick()
    assert mismatches == []
    runner.finish()  # the end-of-run flush routes to on_mismatch
    assert mismatches


def test_runner_serves_only_synctest_sessions():
    """The runner refuses what is no session, and any session whose
    rollback window passes the app's retention: SyncTest's check distance
    and, since P2P sessions are served too, a P2P prediction window."""
    app = make_counter_app()
    with pytest.raises(TypeError, match="SyncTest"):
        GgrsRunner(app, object())
    with pytest.raises(ValueError, match="retention"):
        GgrsRunner(app, SyncTestSession(num_players=1, check_distance=12))
    p2p = (SessionBuilder.for_app(app).with_num_players(2)
           .with_max_prediction_window(12).add_player(PlayerType.LOCAL, 0)
           .add_player(PlayerType.REMOTE, 1, "peer")
           .start_p2p_session(ChannelNetwork().endpoint("me")))
    with pytest.raises(ValueError, match="retention"):
        GgrsRunner(app, p2p)


# -- snapshot ring (the reference's GgrsSnapshots battery) ---------------------


def test_ring_push_peek_and_eviction():
    r = SnapshotRing(depth=3)
    for f in range(5):
        r.push(f, f * 10)
    assert r.frames() == [4, 3, 2]
    assert r.peek(3) == 30 and r.peek(0) is None
    assert r.latest() == 40 and r.latest_frame() == 4
    r.set_depth(2)
    assert r.frames() == [4, 3]


def test_ring_push_replaces_same_and_newer_frames():
    r = SnapshotRing(depth=8)
    for f in range(5):
        r.push(f, f)
    r.push(2, "new")
    assert r.frames() == [2, 1, 0] and r.peek(2) == "new"


def test_ring_rollback_and_missing_frame():
    r = SnapshotRing(depth=8)
    for f in range(6):
        r.push(f, f * 10)
    assert r.rollback(3) == 30
    assert r.frames() == [3, 2, 1, 0]
    with pytest.raises(MissingSnapshotError):
        r.rollback(99)
    assert len(r) == 0


def test_ring_confirm_prunes_older():
    r = SnapshotRing(depth=8)
    r.confirm(100)
    for f in range(6):
        r.push(f, f)
    r.confirm(3)
    assert r.frames() == [5, 4, 3]


def test_ring_wraparound():
    r = SnapshotRing(depth=8)
    seq = [I32_MAX - 1, I32_MAX, I32_MIN, wrap_i32(I32_MIN + 1)]
    for f in seq:
        r.push(f, f)
    assert r.frames() == list(reversed(seq))
    r.confirm(I32_MIN)
    assert r.frames() == [seq[3], I32_MIN]
    r.push(I32_MIN, "redo")
    assert r.frames() == [I32_MIN] and r.rollback(I32_MIN) == "redo"


def test_rollback_many():
    rings = [SnapshotRing(depth=4), SnapshotRing(depth=4)]
    for f in range(3):
        rings[0].push(f, ("a", f))
        rings[1].push(f, ("b", f))
    assert rollback_many(rings, [(1, 0), (0, 2)]) == [(1, ("b", 0)), (0, ("a", 2))]
    assert rings[1].frames() == [0]
