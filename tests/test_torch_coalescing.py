"""Tick coalescing in the port's runner, on the CPU: a host update that owes
N frames flushes up to ``coalesce_frames`` ticks' requests through one
request pass, fusing consecutive advances into one resim.

Mirrors tests/test_coalescing.py.  A coalesced runner must give the
per-tick runner's checksums bit for bit with fewer resims, the pipelined
coalesced runner must read no checksum by force, and on fixed_point both
must equal the JAX runner ticking one frame per update with
``pipeline=False`` (the JAX runner's pipelined and coalesced paths are
not a reference here: they raise SyncTest mismatches under load, ROADMAP
queue C)."""

import numpy as np
import pytest

from bevy_ggrs_tpu import GgrsRunner as JRunner
from bevy_ggrs_tpu import SyncTestSession as JSession
from bevy_ggrs_tpu.models import fixed_point as j_fixed_point
from bevy_ggrs_tpu_torch import GgrsRunner, PlayerType, SessionBuilder, SessionState
from bevy_ggrs_tpu_torch import SyncTestSession
from bevy_ggrs_tpu_torch.models import box_game, fixed_point, stress
from bevy_ggrs_tpu_torch.session.channel import ChannelNetwork

DT = 1.0 / 60.0


def synctest_run(coalesce, ticks=36, chunk=1, pipeline=True, before_finish=None,
                    jax_runner=False, **kw):
    t = [0]

    def read_inputs(handles):
        # deterministic per-frame stream, independent of flush cadence
        t[0] += 1
        return {h: np.uint8((t[0] * 7 + h * 3) & 0xF) for h in handles}

    if jax_runner:
        app, cls, sess = j_fixed_point.make_app(), JRunner, JSession
    else:
        app, cls, sess = fixed_point.make_app(device="cpu"), GgrsRunner, SyncTestSession
    runner = cls(app, sess(num_players=2, input_shape=(), input_dtype=np.uint8,
                           check_distance=3, compare_interval=1),
                 read_inputs=read_inputs,
                 on_mismatch=lambda e: (_ for _ in ()).throw(e),
                 coalesce_frames=coalesce, pipeline=pipeline, **kw)
    done = 0
    while done < ticks:
        n = min(chunk, ticks - done)
        runner.update(n * DT)  # n due frames in one host update
        done += n
    if before_finish is not None:
        before_finish(runner)
    runner.finish()
    return runner


def ring_checksums(runner, frames):
    return [int(runner.ring.peek(f)[1]()) for f in frames]


def shared_frames(a, b):
    shared = sorted(set(a.ring.frames()) & set(b.ring.frames()))
    assert shared
    return shared


def test_coalesced_synctest_bit_identical_and_fewer_dispatches():
    plain = synctest_run(coalesce=1, chunk=1)
    fused = synctest_run(coalesce=4, chunk=4)
    jax_sync = synctest_run(coalesce=1, chunk=1, pipeline=False, jax_runner=True)
    assert fused.frame == plain.frame == jax_sync.frame
    assert fused.checksum == plain.checksum == jax_sync.checksum
    shared = shared_frames(plain, fused)
    assert ring_checksums(plain, shared) == ring_checksums(fused, shared)
    # the point of the feature: 4-frame chunks collapse into fewer resims
    assert fused.resims < plain.resims
    assert fused.ticks == plain.ticks


def test_coalesced_pipelined_bit_identical_without_forced_readbacks():
    """coalesce > 1 with the tick pipeline: the readbacks keep up with fused
    k > 1 resims, bit-equal to the synchronous per-tick runner, with no
    forced read during the run (finish() is outside the window)."""
    sync = synctest_run(coalesce=1, chunk=1, pipeline=False, packed=False)
    window = {}
    piped = synctest_run(coalesce=4, chunk=4, pipeline=True,
                            before_finish=lambda r: window.update(forced=r.readbacks.forced))
    assert window["forced"] == 0
    assert sync.readbacks.forced > 0
    assert piped.frame == sync.frame
    assert piped.checksum == sync.checksum
    shared = shared_frames(sync, piped)
    assert ring_checksums(sync, shared) == ring_checksums(piped, shared)


def test_coalesce_frames_one_is_the_reference_cadence():
    a = synctest_run(coalesce=1, chunk=1)
    b = synctest_run(coalesce=1, chunk=4)  # several due frames, cap 1
    assert b.checksum == a.checksum
    assert b.resims == a.resims


def latency_pair(coalesce):
    net = ChannelNetwork(latency_hops=3, seed=11)
    socks = [net.endpoint("c0"), net.endpoint("c1")]
    runners = []
    for i in range(2):
        app = box_game.make_app(num_players=2, device="cpu")
        session = (SessionBuilder.for_app(app).with_input_delay(1)
                   .add_player(PlayerType.LOCAL, i)
                   .add_player(PlayerType.REMOTE, 1 - i, f"c{1 - i}")
                   .start_p2p_session(socks[i]))

        def read_inputs(handles, i=i):
            key = {0: "right", 1: "down"}[i]
            return {h: box_game.keys_to_input(**{key: True}) for h in handles}

        runners.append(GgrsRunner(app, session, read_inputs=read_inputs,
                                  coalesce_frames=coalesce))
    return net, runners


def test_coalesced_p2p_catchup_under_latency():
    """One peer falls 4 frames behind and catches up in one coalesced
    update while rollbacks from channel latency land in the same flushes;
    the prune after processing keeps the early ticks' load targets."""
    net, runners = latency_pair(coalesce=4)
    for _ in range(300):
        net.deliver()
        for r in runners:
            r.update(0.0)
        if all(r.session.current_state() == SessionState.RUNNING for r in runners):
            break
    flip = [0]

    def flipping(handles):
        flip[0] += 1
        return {h: box_game.keys_to_input(right=(flip[0] // 5) % 2 == 0) for h in handles}

    runners[0].read_inputs = flipping
    # runner 1 ticks every host update; runner 0 only every 4th, owing 4
    for step in range(120):
        net.deliver()
        runners[1].update(DT)
        if step % 4 == 3:
            runners[0].update(4 * DT)
    assert all(r.frame >= 100 for r in runners)
    assert any(r.rollbacks > 0 for r in runners)
    # coalescing batched: runner 0 advanced ~120 frames in ~30 flushes
    assert runners[0].resims < runners[0].frame // 2
    shared = None
    for _ in range(8):
        shared = sorted(set(runners[0].ring.frames()) & set(runners[1].ring.frames()))
        if shared:
            break
        net.deliver()
        runners[1].update(DT)
        runners[0].update(DT)
    assert shared
    f = shared[-1]
    assert runners[0].ring.peek(f)[1]() == runners[1].ring.peek(f)[1]()


def test_coalesce_guardrails():
    """Coalescing deeper than the SyncTest comparison-cell horizon would
    thin the determinism oracle silently; canonical apps cannot pad a
    rollback + catch-up run past their fixed depth.  Both fail at
    set_session."""
    app = fixed_point.make_app(device="cpu")

    def session(d=3):
        return SyncTestSession(num_players=2, input_shape=(), input_dtype=np.uint8,
                               check_distance=d, compare_interval=1)

    # horizon = 3 + 1 + 2 = 6: cap 6 ok, 7 rejected
    GgrsRunner(app, session(), coalesce_frames=6)
    with pytest.raises(ValueError, match="comparison-cell horizon"):
        GgrsRunner(app, session(), coalesce_frames=7)
    with pytest.raises(ValueError, match="coalesce_frames must be"):
        GgrsRunner(app, session(), coalesce_frames=0)
    capp = stress.make_app(64, canonical_depth=8, device="cpu")
    with pytest.raises(ValueError, match="canonical_depth"):
        GgrsRunner(capp, session(4), coalesce_frames=5)  # window 4 + 5 > 8
