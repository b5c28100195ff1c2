"""The port's pipelined runner on the CPU: checksum readback started at
dispatch and harvested (never forced) in steady state, late checksums still
detected, the synchronous mode's forced reads, staging reuse, and the
lossy-channel scenario of ROADMAP queue C.

Mirrors tests/test_pipeline.py where a case applies to a solo runner.  The
pipelined runner's checksum streams must equal the synchronous runner's bit
for bit, and, on fixed_point, the JAX runner's with ``pipeline=False``
(the JAX pipelined path diverges under loss, queue C, so no port test is
held to it); stress and box_game states stay within ``atol=1e-4, rtol=0``
of the JAX runner's (XLA contracts FMAs)."""

import dataclasses
import time

import numpy as np
import pytest
import torch

from bevy_ggrs_tpu import GgrsRunner as JRunner
from bevy_ggrs_tpu import SyncTestSession as JSession
from bevy_ggrs_tpu.models import box_game as j_box_game
from bevy_ggrs_tpu.models import fixed_point as j_fixed_point
from bevy_ggrs_tpu.models import stress as j_stress
from bevy_ggrs_tpu_torch import (
    DesyncDetection,
    GgrsRunner,
    PlayerType,
    SessionBuilder,
    SessionState,
    SyncTestSession,
)
from bevy_ggrs_tpu_torch.models import box_game, fixed_point, stress
from bevy_ggrs_tpu_torch.session.channel import ChannelNetwork
from bevy_ggrs_tpu_torch.session.events import DesyncDetected
from bevy_ggrs_tpu_torch.snapshot.lazy import (
    BatchChecks,
    ReadbackQueue,
    ReadbackStats,
    wrap_single_checksum,
)

DT = 1.0 / 60.0


# -- BatchChecks / ReadbackQueue units ----------------------------------------


def test_harvest_collects_started_copy_without_forcing():
    stats = ReadbackStats()
    batch = BatchChecks(torch.tensor([[1, 2]]), stats)
    rbq = ReadbackQueue()
    rbq.start(batch)
    assert rbq.harvest() >= 1
    assert stats == ReadbackStats(harvested=1)
    assert batch.ref(0).to_int() == (1 << 32) | 2  # read, still no force
    assert stats.forced == 0 and rbq.depth() == 0


def test_pull_pending_counts_unstarted_batch_as_forced():
    stats = ReadbackStats()
    batch = BatchChecks(torch.tensor([[3, 4]]), stats)
    BatchChecks.pull_pending()
    assert stats == ReadbackStats(forced=1)
    assert batch.ref(0).to_int() == (3 << 32) | 4


def test_pull_pending_with_stats_forces_only_that_owners_batches():
    mine, other = ReadbackStats(), ReadbackStats()
    a = BatchChecks(torch.tensor([[1, 2]]), mine)
    b = BatchChecks(torch.tensor([[5, 6]]), other)
    BatchChecks.pull_pending(mine)
    assert mine == ReadbackStats(forced=1) and other == ReadbackStats()
    assert ReadbackQueue().harvest() >= 1  # b is still pending, and lands
    assert other == ReadbackStats(harvested=1)
    assert a.ref(0).to_int() == (1 << 32) | 2 and b.ref(0).to_int() == (5 << 32) | 6


def test_checksum_ref_peek_converges_and_matches_call():
    ref = wrap_single_checksum(torch.tensor([7, 9]))
    got = None
    for _ in range(1000):
        got = ref.peek()
        if got is not None:
            break
    assert got == (7 << 32) | 9
    assert ref() == got  # __call__ is to_int; now a cached read


def test_harvest_starts_batches_that_entered_pending_another_way():
    stats = ReadbackStats()
    batch = BatchChecks(torch.tensor([[5, 6]]), stats)
    assert ReadbackQueue().harvest() >= 1  # started and read in one pass
    assert batch.ref(0).peek() == (5 << 32) | 6
    assert stats == ReadbackStats(harvested=1)


# -- SyncTest: pipeline on/off bit-equality and sync-mode semantics ------------


def synctest_stream(app, pipeline=True, ticks=30, jax_runner=False, **kw):
    rng = np.random.default_rng(5)
    cls, sess = (JRunner, JSession) if jax_runner else (GgrsRunner, SyncTestSession)
    runner = cls(app, sess(num_players=2, check_distance=2, compare_interval=1),
                 read_inputs=lambda hs: {h: np.uint8(rng.integers(0, 16)) for h in hs},
                 on_mismatch=lambda e: (_ for _ in ()).throw(e),
                 pipeline=pipeline, **kw)
    stream = []
    for _ in range(ticks):
        runner.tick()
        stream.append(runner.checksum)
    runner.finish()
    return runner, stream


def test_pipeline_on_off_checksums_bit_identical():
    piped, a = synctest_stream(stress.make_app(128, device="cpu"))
    sync, b = synctest_stream(stress.make_app(128, device="cpu"), pipeline=False,
                              packed=False)
    assert a == b
    assert piped.stats()["donated_dispatches"] > 0


def test_pipelined_fixed_point_equals_jax_sync_runner():
    _, port = synctest_stream(fixed_point.make_app(device="cpu"), ticks=40)
    _, jax_sync = synctest_stream(j_fixed_point.make_app(), pipeline=False, ticks=40,
                                  jax_runner=True)
    assert port == jax_sync


@pytest.mark.parametrize("model", ["stress", "box_game"])
def test_pipelined_float_states_within_tolerance_of_jax_sync_runner(model):
    tmod, jmod = {"stress": (stress, j_stress), "box_game": (box_game, j_box_game)}[model]
    kw = {"n_entities": 64} if model == "stress" else {}
    port, _ = synctest_stream(tmod.make_app(device="cpu", **kw), ticks=40)
    jax_sync, _ = synctest_stream(jmod.make_app(**kw), pipeline=False, ticks=40,
                                  jax_runner=True)
    assert port.frame == jax_sync.frame == 40
    got, want = port.read_components(), jax_sync.read_components()
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(got[name], np.asarray(want[name]), atol=1e-4, rtol=0,
                                   err_msg=name)


def test_sync_mode_forces_readbacks_every_tick():
    runner, _ = synctest_stream(stress.make_app(64, device="cpu"), pipeline=False,
                                ticks=10)
    assert runner.readbacks.forced >= 10
    piped, _ = synctest_stream(stress.make_app(64, device="cpu"), ticks=10)
    assert piped.readbacks.forced == 0


def test_pipeline_default_on_and_counted_in_stats():
    app = stress.make_app(64, device="cpu")
    runner = GgrsRunner(app, SyncTestSession(num_players=2))
    assert runner.pipeline is True and runner.packed is True
    assert runner.enable_donation is True
    assert runner.stats()["pipeline_degrades"] == 0
    runner.finish()


# -- p2p over a deterministic channel -------------------------------------------


def channel_pair(pipeline=True, desync=DesyncDetection.on(1), packed=None):
    net = ChannelNetwork(seed=7)
    socks = [net.endpoint(f"p{i}") for i in range(2)]
    runners = []
    for i in range(2):
        app = box_game.make_app(num_players=2, device="cpu")
        session = (SessionBuilder.for_app(app)
                   .with_input_delay(2)
                   .with_desync_detection_mode(desync)
                   .with_eager_checksums(not pipeline)
                   .add_player(PlayerType.LOCAL, i)
                   .add_player(PlayerType.REMOTE, 1 - i, f"p{1 - i}")
                   .start_p2p_session(socks[i]))
        runners.append(GgrsRunner(
            app, session,
            read_inputs=lambda hs: {h: box_game.keys_to_input(right=True) for h in hs},
            pipeline=pipeline, packed=packed,
        ))
    for _ in range(500):
        net.deliver()
        for r in runners:
            r.update(0.0)
        if all(r.session.current_state() == SessionState.RUNNING for r in runners):
            break
    assert all(r.session.current_state() == SessionState.RUNNING for r in runners)
    return net, runners


def interleave(net, runners, ticks):
    for _ in range(ticks):
        net.deliver()
        for r in runners:
            r.update(DT)


def desyncs(runners):
    return [e for r in runners for e in r.events if isinstance(e, DesyncDetected)]


def test_pipelined_p2p_steady_state_never_forces():
    net, runners = channel_pair()
    interleave(net, runners, 20)  # settle the startup transient
    before = [dataclasses.replace(r.readbacks) for r in runners]
    interleave(net, runners, 60)
    for r, b in zip(runners, before):
        assert r.readbacks.forced == b.forced
        assert r.readbacks.harvested > b.harvested
    assert not desyncs(runners)
    for r in runners:
        r.finish()


def test_sync_runner_beside_pipelined_pair_forces_only_its_own():
    """A synchronous runner in the same process drains its own batches at
    the end of each tick; the pipelined pair's batches are left to its
    harvest, so the pair is charged no forced readback."""
    net, runners = channel_pair()
    interleave(net, runners, 20)
    sync, _ = synctest_stream(stress.make_app(64, device="cpu"), pipeline=False, ticks=1)
    before = [dataclasses.replace(r.readbacks) for r in runners]
    for _ in range(40):
        interleave(net, runners, 1)
        sync.tick()  # dispatches, then pulls its pending batches
    assert sync.readbacks.forced >= 40
    for r, b in zip(runners, before):
        assert r.readbacks.forced == b.forced
        assert r.readbacks.harvested > b.harvested
    assert not desyncs(runners)
    for r in runners + [sync]:
        r.finish()


class LateWrongRef:
    """Checksum provider whose copy 'lands' only after ``late`` polls, and
    then reports a corrupted value."""

    def __init__(self, value, late):
        self.value = value
        self.polls = 0
        self.late = late

    def peek(self):
        self.polls += 1
        return None if self.polls <= self.late else self.value

    def __call__(self):
        return self.value


def test_late_checksum_still_desyncs_at_the_right_frame():
    """A local checksum that resolves polls after the frame is confirmed
    must still be published, compared, and raise DesyncDetected carrying
    that frame: a late readback delays detection, never drops it."""
    net, runners = channel_pair()
    interleave(net, runners, 10)
    sess = runners[1].session
    target = {}
    orig = sess._on_cell_saved

    def corrupting_hook(frame, provider):
        if not target and frame % 2 == 0:
            target["frame"] = frame
            target["ref"] = LateWrongRef(value=0x0BAD_C0DE, late=6)
            orig(frame, target["ref"])
        else:
            orig(frame, provider)

    sess._on_cell_saved = corrupting_hook
    interleave(net, runners, 80)
    assert "frame" in target, "hook never saw a save"
    assert target["ref"].polls > 6, "provider was never re-polled after None"
    found = desyncs(runners)
    assert found, "late-landing corrupted checksum produced no desync"
    assert {e.frame for e in found} == {target["frame"]}
    for r in runners:
        r.finish()


def test_real_divergence_detected_with_pipelining_on():
    net, runners = channel_pair(desync=DesyncDetection.on(2))
    interleave(net, runners, 20)
    w = runners[1].world
    runners[1].world = dataclasses.replace(w, comps={**w.comps, "pos": w.comps["pos"] + 5.0})
    runners[1]._world_checksum = wrap_single_checksum(
        runners[1].app.checksum_fn(runners[1].world))
    interleave(net, runners, 80)
    assert desyncs(runners), "expected DesyncDetected after state divergence"
    for r in runners:
        r.finish()


@pytest.mark.parametrize("packed", [True, False])
def test_persistent_staging_buffer_is_reused(packed):
    net, runners = channel_pair(desync=DesyncDetection.OFF, packed=packed)
    interleave(net, runners, 10)
    r = runners[0]
    bufs = (r._stage_packed,) if packed else (r._stage_inputs, r._stage_status)
    assert all(b is not None for b in bufs)
    interleave(net, runners, 10)
    now = (r._stage_packed,) if packed else (r._stage_inputs, r._stage_status)
    assert all(a is b for a, b in zip(bufs, now)), "staging reallocated per tick"
    assert (r._stage_inputs is None) == packed  # the other path never ran
    for r in runners:
        r.finish()


def test_read_components_drains_inflight_window():
    net, runners = channel_pair(desync=DesyncDetection.OFF)
    interleave(net, runners, 15)
    r = runners[0]
    out = r.read_components(["pos"])
    assert np.array_equal(out["pos"], r.world.comps["pos"].numpy())
    assert "__active__" in out
    for r in runners:
        r.finish()


# -- the lossy channel of ROADMAP queue C -----------------------------------------


def lossy_game(seed: int, ticks: int = 250):
    """Two pipelined port peers over latency 2, loss 0.1, jitter 2, random
    held inputs and jittered host ticks (tests/test_speculation_soak.py's
    game with speculation off)."""
    net = ChannelNetwork(latency_hops=2, loss=0.1, seed=seed, jitter_hops=2)
    socks = [net.endpoint("a"), net.endpoint("b")]
    rngs = [np.random.default_rng(1000 * seed + i) for i in range(2)]
    runners = []
    for i in range(2):
        app = box_game.make_app(num_players=2, device="cpu")
        session = (SessionBuilder.for_app(app)
                   .with_input_delay(1)
                   .with_max_prediction_window(8)
                   .with_desync_detection_mode(DesyncDetection.on(1))
                   .with_disconnect_timeout(60.0)
                   .with_disconnect_notify_delay(30.0)
                   .add_player(PlayerType.LOCAL, i)
                   .add_player(PlayerType.REMOTE, 1 - i, "b" if i == 0 else "a")
                   .start_p2p_session(socks[i]))

        def read_inputs(handles, i=i):
            return {h: np.uint8(rngs[i].integers(0, 8)) for h in handles}

        runners.append(GgrsRunner(app, session, read_inputs=read_inputs))
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        net.deliver()
        for r in runners:
            r.update(0.0)
        if all(r.session.current_state() == SessionState.RUNNING for r in runners):
            break
        time.sleep(0.002)
    assert all(r.session.current_state() == SessionState.RUNNING for r in runners)
    dt_rng = np.random.default_rng(seed)
    for _ in range(ticks):
        net.deliver()
        for r in runners:
            r.update(DT * float(dt_rng.uniform(0.5, 1.5)))
    return net, runners


@pytest.mark.parametrize("seed", range(15))
def test_lossy_channel_pipelined_pair_never_diverges(seed):
    net, runners = lossy_game(seed)
    assert all(r.frame > 100 for r in runners)
    assert all(r.stats()["donated_dispatches"] > 0 for r in runners)
    assert any(r.rollbacks > 0 for r in runners)
    common = []
    for _ in range(120):
        net.deliver()
        for r in runners:
            r.update(DT)
        confirmed = min(r.confirmed for r in runners)
        common = [f for f in sorted(set(runners[0].ring.frames())
                                    & set(runners[1].ring.frames())) if f <= confirmed]
        if common:
            break
    assert common, "the peers' rings never overlapped"
    cs = [r.ring.peek(common[-1])[1]() for r in runners]
    assert cs[0] == cs[1], f"diverged at frame {common[-1]} (seed {seed})"
    assert not desyncs(runners)
