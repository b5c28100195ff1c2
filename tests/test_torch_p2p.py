"""The port's P2P and spectator sessions driving its runner, on the CPU.

Mirrors tests/test_channel_transport.py, tests/test_p2p.py and
tests/test_disconnect.py over the in-memory ``ChannelNetwork`` (3 hops of
latency, no loss), so every game is deterministic: one peer's inputs flip
every 7 frames as a function of the frame, the other peer mispredicts
them and rolls back.  A pair of port peers, and a mixed pair of one JAX
peer and one port peer on ``fixed_point``, must roll back, raise no
``DesyncDetected`` while comparing checksums every frame, and hold equal
checksums at every frame both rings keep: exact equality of the 64-bit
checksums (tolerance 0).  Protocol timers that must expire (disconnects)
run on a virtual clock."""

import dataclasses

import numpy as np
import pytest
import torch

import bevy_ggrs_tpu as J
import bevy_ggrs_tpu_torch as T
from bevy_ggrs_tpu.models import fixed_point as j_fixed_point
from bevy_ggrs_tpu.snapshot.checksum import checksum_to_int as j_checksum_to_int
from bevy_ggrs_tpu_torch import (
    DesyncDetection,
    GgrsRunner,
    InputStatus,
    InvalidRequestError,
    PlayerType,
    SessionBuilder,
    SessionState,
)
from bevy_ggrs_tpu_torch.models import box_game, fixed_point
from bevy_ggrs_tpu_torch.session import p2p as t_p2p
from bevy_ggrs_tpu_torch.session import protocol as t_proto
from bevy_ggrs_tpu_torch.session.channel import ChannelNetwork
from bevy_ggrs_tpu_torch.session.events import (
    DesyncDetected,
    Disconnected,
    NetworkInterrupted,
    Synchronized,
    Synchronizing,
)
from bevy_ggrs_tpu_torch.snapshot.lazy import (
    BatchChecks,
    ReadbackStats,
    wrap_single_checksum,
)

DT = 1.0 / 60.0
FLIP = 7  # frames between input flips of the flipping peer


def frame_inputs(i, holder):
    """Peer ``i``'s inputs as a function of the frame: peer 0 flips between
    right and up every FLIP frames, peer 1 holds right (so only peer 1
    mispredicts)."""
    def read_inputs(handles):
        on = (holder[0].frame // FLIP) % 2 == 0 if i == 0 else True
        return {h: np.uint8(8 if on else 1) for h in handles}
    return read_inputs


def make_peer(pkg, mod, i, sock, desync=1, timeout=2.0, device="cpu", **app_kw):
    """One peer of a 2-player game: its app, session and runner."""
    if device is not None:
        app_kw["device"] = device
    app = mod.make_app(num_players=2, **app_kw)
    b = (pkg.SessionBuilder.for_app(app)
         .with_input_delay(1)
         .with_max_prediction_window(8)
         .with_disconnect_timeout(timeout)
         .with_disconnect_notify_delay(timeout / 4)
         .add_player(pkg.PlayerType.LOCAL, i)
         .add_player(pkg.PlayerType.REMOTE, 1 - i, f"p{1 - i}"))
    if desync:
        b = b.with_desync_detection_mode(pkg.DesyncDetection.on(desync))
    holder = []
    runner = pkg.GgrsRunner(app, b.start_p2p_session(sock),
                            read_inputs=frame_inputs(i, holder))
    holder.append(runner)
    return runner


def port_pair(mod, net, **kw):
    socks = [net.endpoint("p0"), net.endpoint("p1")]
    return [make_peer(T, mod, i, socks[i], **kw) for i in range(2)]


def drive(net, runners, ticks, dt=DT):
    for _ in range(ticks):
        net.deliver()
        for r in runners:
            r.update(dt)


def sync(net, runners):
    for _ in range(100):
        drive(net, runners, 1, dt=0.0)
        if all(r.session.current_state().value == "running" for r in runners):
            return
    raise AssertionError("sessions never synchronized")


def ring_checksum(runner, frame):
    entry = runner.ring.peek(frame)
    if entry is None:
        return None
    ref = entry[1]
    return ref() if isinstance(runner, GgrsRunner) else j_checksum_to_int(ref)


def assert_rings_agree(r0, r1):
    shared = sorted(set(r0.ring.frames()) & set(r1.ring.frames()))
    assert shared, "rings share no frame"
    for f in shared:
        assert ring_checksum(r0, f) == ring_checksum(r1, f), f"frame {f}"
    return shared


def count_comparisons(runner):
    """Count the frames whose local checksum met a remote report."""
    s = runner.session
    compared = []
    original = s._compare_checksum

    def compare(frame, local):
        if any(f == frame for (_, f) in s._remote_checksums):
            compared.append(frame)
        original(frame, local)

    s._compare_checksum = compare
    return compared


def desyncs(runner):
    return [e for e in runner.events if isinstance(e, DesyncDetected)]


@pytest.mark.parametrize("model", ["box_game", "fixed_point"])
def test_port_pair_rolls_back_and_stays_in_sync(model):
    mod = {"box_game": box_game, "fixed_point": fixed_point}[model]
    net = ChannelNetwork(latency_hops=3, seed=1)
    runners = port_pair(mod, net)
    confirmed = [[], []]
    for r, seen in zip(runners, confirmed):
        r.on_confirmed = seen.append
    compared = [count_comparisons(r) for r in runners]
    sync(net, runners)
    drive(net, runners, 150)
    for r in runners:
        r.finish()
    r0, r1 = runners
    assert r0.frame >= 140 and r1.frame >= 140
    assert r1.rollbacks > 10 and r1.rollback_frames >= 2 * r1.rollbacks
    for i, r in enumerate(runners):
        assert not desyncs(r)
        assert sum(r.rollbacks_by_cause.values()) == r.rollbacks
        assert set(r.rollbacks_by_cause) <= {1 - i}  # the remote handle
        assert r.resims == r.frame  # one resim per tick, rollback or not
        assert r.readbacks.forced == r.readbacks.peek_misses == 0  # CPU
        assert r.readbacks.harvested > 100  # every compared frame, read at once
        assert len(compared[i]) > 100
        assert confirmed[i] == sorted(confirmed[i]) and confirmed[i][-1] > 130
    assert_rings_agree(r0, r1)


@pytest.mark.parametrize("port_handle", [0, 1])
def test_jax_peer_and_port_peer_stay_in_sync(port_handle):
    """fixed_point is integer math, so the JAX and port states, and with
    them the checksums, are bit-identical; box_game and stress_soa are not
    paired across packages (float FMA contraction, ROADMAP queue C)."""
    net = ChannelNetwork(latency_hops=3, seed=2)
    socks = [net.endpoint("p0"), net.endpoint("p1")]
    runners = []
    for i in range(2):
        if i == port_handle:
            runners.append(make_peer(T, fixed_point, i, socks[i], timeout=30.0))
        else:  # a jit compile must not read as peer silence: long timeout
            runners.append(make_peer(J, j_fixed_point, i, socks[i], timeout=30.0,
                                     device=None))
    compared = [count_comparisons(r) for r in runners]
    sync(net, runners)
    drive(net, runners, 150)
    for r in runners:
        r.finish()
    r0, r1 = runners
    assert r0.frame >= 140 and r1.frame >= 140
    assert r0.rollbacks > 0 and r1.rollbacks > 10
    for i, r in enumerate(runners):
        assert not desyncs(r), desyncs(r)
        assert len(compared[i]) > 100
    assert len(assert_rings_agree(r0, r1)) >= 2


def test_forced_desync_is_detected():
    net = ChannelNetwork(latency_hops=3, seed=3)
    runners = port_pair(box_game, net)
    heard = [[], []]  # every event on_event passed on, per peer
    for r, seen in zip(runners, heard):
        r.on_event = seen.append
    sync(net, runners)
    drive(net, runners, 40)
    assert not any(desyncs(r) for r in runners)
    # peer 0 predicts its remote perfectly, so it never rolls back: the
    # offset stays in its world until the checksums expose it
    r0 = runners[0]
    w = r0.world
    r0.world = dataclasses.replace(w, comps={**w.comps, "pos": w.comps["pos"] + 0.5})
    r0._world_checksum = wrap_single_checksum(r0.app.checksum_fn(r0.world))
    start = r0.frame
    while not any(desyncs(r) for r in runners) and r0.frame < start + 60:
        drive(net, runners, 1)
    found = [e for r in runners for e in desyncs(r)]
    assert found, "no DesyncDetected within 60 frames of the offset"
    assert all(e.local_checksum != e.remote_checksum for e in found)
    for r, seen in zip(runners, heard):
        assert seen == r.events  # on_event saw each event once, in order
    for seen in heard:  # the handshake's events, then any desync
        order = [type(e) for e in seen]
        last = len(order) if DesyncDetected not in order else order.index(DesyncDetected)
        assert order.index(Synchronizing) < order.index(Synchronized) < last


def test_stalls_without_remote_peer():
    net = ChannelNetwork()
    silent = net.endpoint("p1")
    runner = make_peer(T, box_game, 0, net.endpoint("p0"), desync=0)
    session = runner.session
    for _ in range(20):  # the silent peer only answers the handshake
        runner.update(0.0)
        net.deliver()
        for addr, data in silent.receive_all():
            _, t = t_proto.HDR.unpack_from(data)
            if t == t_proto.T_SYNC_REQ:
                nonce, _ = t_proto.S_SYNC_REQ.unpack_from(data[t_proto.HDR.size:])
                silent.send_to(t_proto.HDR.pack(t_proto.MAGIC, t_proto.T_SYNC_REP)
                               + t_proto.S_SYNC_REP.pack(nonce, t_proto.PROTOCOL_VERSION),
                               addr)
        net.deliver()
    assert session.current_state() == SessionState.RUNNING
    for _ in range(30):
        runner.update(DT)
    assert runner.frame == session.max_prediction()  # ran to the window, then stalled
    assert runner.stalled_frames == 30 - runner.frame


def _spectated_game(net, catchup=1):
    socks = [net.endpoint(n) for n in ("p0", "p1", "spec")]
    hosts = []
    for i in range(2):
        app = box_game.make_app(num_players=2, device="cpu")
        b = (SessionBuilder.for_app(app).with_input_delay(1)
             .add_player(PlayerType.LOCAL, i)
             .add_player(PlayerType.REMOTE, 1 - i, f"p{1 - i}"))
        if i == 0:  # the host streams confirmed inputs to the spectator
            b.add_player(PlayerType.SPECTATOR, 2, "spec")
        holder = []
        hosts.append(GgrsRunner(app, b.start_p2p_session(socks[i]),
                                read_inputs=frame_inputs(i, holder)))
        holder.append(hosts[-1])
    app = box_game.make_app(num_players=2, device="cpu")
    session = (SessionBuilder.for_app(app).with_catchup_speed(catchup)
               .start_spectator_session("p0", socks[2]))
    return hosts, GgrsRunner(app, session)


def test_spectator_follows_the_host_bit_for_bit():
    net = ChannelNetwork(latency_hops=3, seed=4)
    hosts, spec = _spectated_game(net)
    host_checks = {}
    hosts[0].on_confirmed = lambda f: host_checks.setdefault(f, hosts[0].ring.peek(f)[1])
    everyone = hosts + [spec]
    sync(net, everyone)
    matched = 0
    for _ in range(120):
        drive(net, everyone, 1)
        if spec.frame in host_checks:
            assert spec.checksum == host_checks[spec.frame]()
            matched += 1
    assert spec.session.current_state() == SessionState.RUNNING
    assert spec.frame > 90 and matched > 80
    assert spec.rollbacks == 0 and len(spec.ring) == 0  # no saves, no loads
    # the spectator replays the true world: player 1 held right
    assert float(spec.world.comps["pos"][1, 0]) > -1.0


def test_spectator_catches_up():
    catchup = 3
    net = ChannelNetwork(latency_hops=1, seed=5)
    hosts, spec = _spectated_game(net, catchup)
    everyone = hosts + [spec]
    sync(net, everyone)
    for _ in range(40):  # the hosts advance while the spectator sits idle
        net.deliver()
        for r in hosts:
            r.update(DT)
        spec.update(0.0)
    behind = spec.session.frames_behind_host()
    assert behind > 2 * catchup
    steps = []
    for _ in range(40):
        before = spec.frame
        drive(net, everyone, 1)
        steps.append(spec.frame - before)
        if spec.session.frames_behind_host() <= 2:
            break
    assert max(steps) == 1 + catchup
    assert len(steps) <= behind // catchup + 3


@pytest.fixture
def clock(monkeypatch):
    """A virtual protocol clock: disconnect timers expire by ticks, not by
    the wall clock."""
    now = {"t": 1000.0}
    monkeypatch.setattr(t_proto, "now_s", lambda: now["t"])
    monkeypatch.setattr(t_p2p, "now_s", lambda: now["t"])
    return now


def test_survivor_continues_after_disconnect(clock):
    net = ChannelNetwork(latency_hops=3, seed=6)
    runners = port_pair(box_game, net, timeout=0.25)
    sync(net, runners)
    for _ in range(20):
        clock["t"] += DT
        drive(net, runners, 1)
    survivor = runners[0]
    at_death = survivor.frame
    for _ in range(60):  # peer 1 dies: only the survivor ticks
        clock["t"] += DT
        net.deliver()
        survivor.update(DT)
    kinds = [type(e) for e in survivor.events]
    assert kinds.index(NetworkInterrupted) < kinds.index(Disconnected)
    assert survivor.frame > at_death + 40
    _, status = survivor.session._inputs_for(survivor.frame - 1)
    assert status[1] == InputStatus.DISCONNECTED
    assert not desyncs(survivor)


def test_session_restart_resets_the_runner():
    net = ChannelNetwork(latency_hops=2, seed=7)
    runners = port_pair(fixed_point, net)
    sync(net, runners)
    drive(net, runners, 30)
    assert runners[0].frame >= 25
    for r in runners:
        r.set_session(None)
        r.update(1.0)  # no session: the accumulator clears, nothing advances
        assert r.frame == 0 and len(r.ring) == 0
    net2 = ChannelNetwork(latency_hops=2, seed=7)
    socks = [net2.endpoint("p0"), net2.endpoint("p1")]
    for i, r in enumerate(runners):
        r.set_session(SessionBuilder.for_app(r.app).with_input_delay(1)
                      .add_player(PlayerType.LOCAL, i)
                      .add_player(PlayerType.REMOTE, 1 - i, f"p{1 - i}")
                      .start_p2p_session(socks[i]))
    sync(net2, runners)
    drive(net2, runners, 20)
    assert all(r.frame >= 15 for r in runners)


def test_checksum_refs_on_cpu_read_at_once():
    stats = ReadbackStats()
    batch = BatchChecks(torch.tensor([[1, 2], [0xFFFFFFFF, 3]]), stats)
    assert batch.ref(1).peek() == (0xFFFFFFFF << 32) | 3
    assert batch.ref(0)() == (1 << 32) | 2
    assert stats == ReadbackStats(peek_misses=0, harvested=1, forced=0)
    app = fixed_point.make_app(device="cpu")
    world = app.init_state()
    ref = wrap_single_checksum(app.checksum_fn(world))
    assert ref() == ref.peek() == T.GgrsRunner(app).checksum


def test_builder_validates_players_and_options():
    b = SessionBuilder().with_num_players(2).add_player(PlayerType.LOCAL, 0)
    with pytest.raises(InvalidRequestError):
        b.start_p2p_session(ChannelNetwork().endpoint("x"))
    with pytest.raises(InvalidRequestError):
        b.add_player(PlayerType.REMOTE, 1)  # a remote needs an address
    with pytest.raises(InvalidRequestError):
        b.add_player(PlayerType.LOCAL, 5)
    with pytest.raises(ValueError):
        b.with_catchup_speed(0)
    assert DesyncDetection.on(3).interval == 3 and not DesyncDetection.OFF.enabled
