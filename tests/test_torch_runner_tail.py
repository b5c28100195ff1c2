"""The runner's main-path tail on the port, held against the JAX package.

- ``on_advance(frame, inputs, status)``: called once per AdvanceFrame in
  frame order; on the same SyncTest game the port runner records exactly
  the JAX runner's sequence, on the plain, coalesced, canonical-branched
  and cache-hit paths alike; on a mixed JAX-peer / port-peer P2P game the
  two peers' last records of every frame both confirmed are equal.
- Mirrors, port against JAX (the states of float models within
  ``atol=1e-4, rtol=0``, XLA's FMAs; integers and checksums exact):
  ``tests/test_wraparound.py`` (3 tests), ``test_structured_inputs.py``
  (2), ``test_multi_handle.py`` (Python core and native core),
  ``test_resource_lifecycle.py`` (2), ``test_three_peers.py`` and the
  request-fusion property test of ``test_runner_batching.py`` (the port's
  fused runner against a one-request-at-a-time runner and the JAX
  runner on random scripts).  The P2P mirrors run port against port,
  as the references do, and their confirmed checksums exactly."""

import dataclasses
import shutil
import socket
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bevy_ggrs_tpu as J
import bevy_ggrs_tpu.snapshot as JS
import bevy_ggrs_tpu_torch as T
import bevy_ggrs_tpu_torch.snapshot as TS
from bevy_ggrs_tpu.models import box_game as j_box_game
from bevy_ggrs_tpu.models import fixed_point as j_fixed_point
from bevy_ggrs_tpu.session.requests import AdvanceRequest as JAdvance
from bevy_ggrs_tpu.session.requests import LoadRequest as JLoad
from bevy_ggrs_tpu.session.requests import SaveCell as JSaveCell
from bevy_ggrs_tpu.session.requests import SaveRequest as JSave
from bevy_ggrs_tpu_torch import (
    GgrsRunner,
    PlayerType,
    SessionBuilder,
    SessionState,
    SpeculationConfig,
    pad_candidates,
)
from bevy_ggrs_tpu_torch.convert import to_numpy
from bevy_ggrs_tpu_torch.models import box_game, fixed_point
from bevy_ggrs_tpu_torch.session.channel import ChannelNetwork
from bevy_ggrs_tpu_torch.session.input_queue import InputQueue
from bevy_ggrs_tpu_torch.session.requests import (
    AdvanceRequest,
    LoadRequest,
    SaveCell,
    SaveRequest,
)
from bevy_ggrs_tpu_torch.snapshot import checksum_to_int
from bevy_ggrs_tpu_torch.snapshot.ring import SnapshotRing
from bevy_ggrs_tpu_torch.utils.frames import I32_MAX, frame_add, wrap_i32
from tests.test_torch_p2p import count_comparisons, desyncs, make_peer
from tests.test_torch_speculative_runner import ScriptedSession, make_deep_script

DT = 1.0 / 60.0
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


def _record(log):
    def on_advance(frame, inputs, status):
        log.append((int(frame), np.asarray(inputs).tolist(), np.asarray(status).tolist()))
    return on_advance


def _flipping(holder):
    def read_inputs(handles):
        phase = (holder[0].frame // 3) % 4
        return {h: np.uint8(1 << ((phase + h) % 4)) for h in handles}
    return read_inputs


def _synctest_log(pkg, mod, frames=30, app_kw=None, canonical=None, **runner_kw):
    app = mod.make_app(**(app_kw or {}))
    for name, value in (canonical or {}).items():
        setattr(app, name, value)  # before first use
    session = pkg.SyncTestSession(num_players=2, check_distance=4)
    holder, log = [], []
    if pkg is J:
        runner_kw.setdefault("pipeline", False)
    runner = pkg.GgrsRunner(app, session, read_inputs=_flipping(holder),
                            on_advance=_record(log), **runner_kw)
    holder.append(runner)
    for _ in range(frames):
        runner.tick()
    runner.finish()
    return log, runner


@pytest.mark.parametrize("mode", ["plain", "coalesced", "branched"])
def test_on_advance_sequence_equals_jax_runner(mode):
    """Every AdvanceFrame of a SyncTest d=4 game (re-simulated frames
    included), in order, with its inputs and statuses."""
    app_kw, kw = {"device": "cpu"}, {}
    if mode == "coalesced":
        kw = {"coalesce_frames": 3}
    if mode == "branched":
        kw = {"canonical": {"canonical_depth": 8, "canonical_branches": 3}}
    port, _runner = _synctest_log(T, fixed_point, app_kw=app_kw, **kw)
    jax_side, _ = _synctest_log(J, j_fixed_point)
    assert len(port) > 30 and port == jax_side


def test_on_advance_on_the_cache_hit_path():
    """A fully hedged rollback runs no resim, yet reports each of its
    advances, as the JAX runner (no cache) does on the same script."""
    depth = 3
    up = box_game.keys_to_input(up=True)
    port_log, jax_log = [], []
    sess = ScriptedSession()
    sess.script = make_deep_script(sess, up, depth)
    runner = GgrsRunner(box_game.make_app(device="cpu"), sess, on_advance=_record(port_log),
                        speculation=SpeculationConfig(
                            candidates_fn=pad_candidates(2, [1], list(range(16))), depth=4))
    jsess = ScriptedSession()
    jsess.script = make_deep_script(jsess, up, depth, (JAdvance, JLoad, JSave, JSaveCell))
    jr = J.GgrsRunner(j_box_game.make_app(), jsess, pipeline=False,
                      on_advance=_record(jax_log))
    for _ in range(depth + 1):
        runner.tick()
        jr.tick()
    assert runner.cache_served_frames == depth + 1
    assert port_log == jax_log
    assert [f for f, _, _ in port_log] == [1, 2, 3, 1, 2, 3, 4]


def test_on_advance_on_a_mixed_p2p_pair():
    """A JAX peer and a port peer of one fixed_point game: per frame, the
    last inputs each peer reported are equal wherever both confirmed it
    (the statuses are each peer's own: a remote input predicted right is
    never re-advanced as confirmed), and each peer's reports run in frame
    order within every run."""
    net = ChannelNetwork(latency_hops=3, seed=2)
    socks = [net.endpoint("p0"), net.endpoint("p1")]
    runners = [make_peer(T, fixed_point, 0, socks[0], timeout=30.0),
               make_peer(J, j_fixed_point, 1, socks[1], timeout=30.0, device=None)]
    logs = [[], []]
    for r, log in zip(runners, logs):
        r.on_advance = _record(log)
    for _ in range(100):
        net.deliver()
        for r in runners:
            r.update(0.0)
        if all(r.session.current_state().value == "running" for r in runners):
            break
    for _ in range(90):
        net.deliver()
        for r in runners:
            r.update(DT)
    conf = min(r.session.confirmed_frame() for r in runners)
    assert conf > 60 and runners[1].rollbacks > 0
    last = []
    for log in logs:
        per_frame = {}
        for (f, inp, _st), nxt in zip(log, log[1:] + [None]):
            per_frame[f] = inp
            assert nxt is None or nxt[0] == f + 1 or nxt[0] <= f  # runs or rollbacks
        last.append(per_frame)
    for f in range(1, conf + 1):
        assert last[0][f] == last[1][f], f


# -- tests/test_wraparound.py ------------------------------------------------------


def wrap_app(pkg, despawn_at=None, retention=6):
    S = JS if pkg is J else TS
    xp = jnp if pkg is J else torch
    kw = {} if pkg is J else {"device": "cpu"}
    app = pkg.App(num_players=1, capacity=4, input_shape=(), input_dtype=np.uint8,
                  retention=retention, **kw)
    app.rollback_component("counter", (), xp.int32, checksum=True)

    def step(world, ctx):
        m = S.active_mask(world) & world.has["counter"]
        cnt = xp.where(m, world.comps["counter"] + 1, world.comps["counter"])
        world = dataclasses.replace(world, comps={**world.comps, "counter": cnt})
        if despawn_at is not None:
            kill = m & (ctx.frame == despawn_at)
            world = S.despawn_where(app.reg, world, kill, ctx.frame)
        return world

    def setup(world):
        world, _ = S.spawn(app.reg, world, {"counter": 0})
        return world

    app.set_step(step)
    app.set_setup(setup)
    return app


def wrap_run(pkg, app, start_frame, ticks, check_distance=3):
    session = pkg.SyncTestSession(num_players=1, input_shape=(), input_dtype=np.uint8,
                                  check_distance=check_distance, initial_frame=start_frame)
    mismatches = []
    kw = {"pipeline": False} if pkg is J else {}
    runner = pkg.GgrsRunner(app, session, on_mismatch=mismatches.append, **kw)
    stream = []
    for _ in range(ticks):
        runner.tick()
        stream.append(runner.checksum)
    return runner, mismatches, stream


def wrap_both(start, ticks, **kw):
    port = wrap_run(T, wrap_app(T, **kw), start, ticks)
    jax_side = wrap_run(J, wrap_app(J, **kw), start, ticks)
    assert port[1] == jax_side[1] == []
    assert port[2] == jax_side[2]
    assert port[0].frame == jax_side[0].frame
    return port[0]


def test_session_crosses_i32_boundary():
    start = I32_MAX - 5
    runner = wrap_both(start, 15)
    assert int(runner.world.comps["counter"][0]) == 15
    assert runner.frame == frame_add(start, 15) and runner.frame < 0
    assert len(runner.ring) <= runner.ring.depth


def test_retention_guard_uses_session_rollback_window():
    app = wrap_app(T, retention=6)
    session = T.SyncTestSession(num_players=1, input_shape=(), input_dtype=np.uint8,
                                check_distance=7)
    with pytest.raises(ValueError, match="rollback window"):
        GgrsRunner(app, session)
    with pytest.raises(ValueError, match="rollback window"):
        J.GgrsRunner(wrap_app(J, retention=6), J.SyncTestSession(
            num_players=1, input_shape=(), input_dtype=np.uint8, check_distance=7))
    assert T.SyncTestSession(num_players=1, check_distance=3).rollback_window() == 3


def test_despawn_across_boundary():
    runner = wrap_both(I32_MAX - 3, 14, despawn_at=wrap_i32(I32_MAX - 1), retention=6)
    assert int(TS.active_count(runner.world)) == 0
    assert not bool(runner.world.alive[0])  # freed on the far side of the wrap


# -- tests/test_structured_inputs.py -----------------------------------------------


def stick_app(pkg):
    S = JS if pkg is J else TS
    xp = jnp if pkg is J else torch
    kw = {} if pkg is J else {"device": "cpu"}
    app = pkg.App(num_players=2, capacity=4, input_shape=(2,), input_dtype=np.int16, **kw)
    app.rollback_component("pos", (2,), xp.float32, checksum=True)
    app.rollback_component("handle", (), xp.int32, checksum=True)

    def step(world, ctx):
        h = world.comps["handle"]
        m = S.active_mask(world) & world.has["handle"]
        stick = (ctx.inputs.astype(jnp.float32) if pkg is J
                 else ctx.inputs.to(torch.float32)) / np.float32(100.0)
        delta = stick[xp.clip(h, 0, ctx.inputs.shape[0] - 1)]
        pos = world.comps["pos"] + xp.where(m[:, None], delta, np.float32(0.0))
        return dataclasses.replace(world, comps={**world.comps, "pos": pos})

    def setup(world):
        for h in range(2):
            world, _ = S.spawn(app.reg, world, {"pos": np.zeros(2), "handle": h})
        return world

    app.set_step(step)
    app.set_setup(setup)
    return app


def test_vector_input_synctest():
    worlds = []
    for pkg in (T, J):
        session = pkg.SyncTestSession(num_players=2, input_shape=(2,), input_dtype=np.int16,
                                      check_distance=3)
        mismatches = []
        kw = {"pipeline": False} if pkg is J else {}
        runner = pkg.GgrsRunner(
            stick_app(pkg), session,
            read_inputs=lambda hs: {h: np.array([100 if h == 0 else 0, 50], np.int16)
                                    for h in hs},
            on_mismatch=mismatches.append, **kw)
        for _ in range(20):
            runner.tick()
        assert mismatches == []
        worlds.append(runner.world)
    pos = to_numpy(worlds[0].comps["pos"])
    assert abs(pos[0, 0] - 20.0) < 1e-4 and abs(pos[1, 0]) < 1e-6
    assert abs(pos[1, 1] - 10.0) < 1e-4
    np.testing.assert_allclose(pos, np.asarray(worlds[1].comps["pos"]), rtol=0,
                               atol=FLOAT_ATOL)


def test_vector_input_queue_roundtrip():
    q = InputQueue(input_shape=(2,), input_dtype=np.int16, delay=1)
    assert q.add_local(4, np.array([7, -3], np.int16)) == 5
    v, _st = q.input_for(5)
    assert v.tolist() == [7, -3]
    jq = J.session.input_queue.InputQueue(input_shape=(2,), input_dtype=np.int16, delay=1)
    assert jq.add_local(4, np.array([7, -3], np.int16)) == 5
    assert jq.input_for(5)[0].tolist() == v.tolist()


# -- tests/test_multi_handle.py ----------------------------------------------------


def _free_ports(n):
    ports = []
    for _ in range(n):
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        s.bind(("127.0.0.1", 0))
        ports.append(s.getsockname()[1])
        s.close()
    return ports


@pytest.mark.parametrize("native", [False, True])
def test_two_local_players_per_peer(native):
    if native and shutil.which("g++") is None:
        pytest.skip("g++ is absent: the native core cannot be built")
    if native:
        ports = _free_ports(2)
    else:
        net = ChannelNetwork()
        socks = [net.endpoint("A"), net.endpoint("B")]
    keys = [box_game.keys_to_input(right=True), box_game.keys_to_input(up=True),
            box_game.keys_to_input(left=True), box_game.keys_to_input(down=True)]
    runners = []
    for i in range(2):
        app = box_game.make_app(num_players=4, device="cpu")
        # local handles in descending order: the wire row order must not
        # depend on add_player order
        mine, theirs = ([1, 0], [2, 3]) if i == 0 else ([3, 2], [0, 1])
        b = SessionBuilder.for_app(app).with_input_delay(1)
        for h in mine:
            b.add_player(PlayerType.LOCAL, h)
        for h in theirs:
            b.add_player(PlayerType.REMOTE, h,
                         ("127.0.0.1", ports[1 - i]) if native else "BA"[i == 1])
        session = (b.start_p2p_session_native(local_port=ports[i]) if native
                   else b.start_p2p_session(socks[i]))
        runners.append(GgrsRunner(app, session, read_inputs=lambda hs: {h: keys[h] for h in hs}))
        assert sorted(session.local_player_handles()) == sorted(mine)
    for _ in range(400):
        if not native:
            net.deliver()
        for r in runners:
            r.update(0.0)
        if all(r.session.current_state() == SessionState.RUNNING for r in runners):
            break
        time.sleep(0.001)
    assert all(r.session.current_state() == SessionState.RUNNING for r in runners)
    for _ in range(60):
        if not native:
            net.deliver()
        for r in runners:
            r.update(DT)
    for r in runners:
        pos = to_numpy(r.world.comps["pos"])
        assert pos[0, 0] > 1.9 and pos[2, 0] < -1.9 + 2.0 and r.frame >= 50
    shared = []
    for _ in range(6):
        shared = sorted(set(runners[0].ring.frames()) & set(runners[1].ring.frames()))
        if shared:
            break
        if not native:
            net.deliver()
        (runners[0] if runners[0].frame <= runners[1].frame else runners[1]).update(DT)
    assert shared
    f = shared[-1]
    assert runners[0].ring.peek(f)[1]() == runners[1].ring.peek(f)[1]()


# -- tests/test_resource_lifecycle.py ----------------------------------------------


def _res_run(pkg, build, ticks, check_distance):
    kw = {} if pkg is J else {"device": "cpu"}
    app = pkg.App(num_players=1, capacity=8, input_shape=(), input_dtype=np.uint8, **kw)
    build(pkg, app)
    session = pkg.SyncTestSession(num_players=1, input_shape=(), input_dtype=np.uint8,
                                  check_distance=check_distance)
    mismatches = []
    rkw = {"pipeline": False} if pkg is J else {}
    runner = pkg.GgrsRunner(app, session, on_mismatch=mismatches.append, **rkw)
    stream = []
    for _ in range(ticks):
        runner.tick()
        stream.append(runner.checksum)
    assert mismatches == []
    return runner, stream


def test_resource_insert_remove_mid_session():
    def build(pkg, app):
        xp = jnp if pkg is J else torch
        app.rollback_resource("frame_log", np.int32(0), checksum=True)
        app.rollback_resource("score", np.int32(0), checksum=True, present=False)

        def step(world, ctx):
            world = dataclasses.replace(
                world, res={**world.res, "frame_log": world.res["frame_log"] + 1})
            in_window = (ctx.frame >= 5) & (ctx.frame < 10)
            if pkg is T:
                in_window = torch.tensor(bool(in_window))
            return dataclasses.replace(
                world,
                res={**world.res, "score": xp.where(
                    in_window, world.res["score"] + 10, world.res["score"])},
                res_present={**world.res_present, "score": in_window})

        app.set_step(step)

    (port, ps), (jr, js) = (_res_run(pkg, build, 20, 3) for pkg in (T, J))
    assert ps == js
    assert int(port.world.res["frame_log"]) == 20
    assert not bool(port.world.res_present["score"])  # removed after frame 10
    assert int(port.world.res["score"]) == int(jr.world.res["score"]) == 50


def test_resource_with_entity_reference_survives_rollback():
    def build(pkg, app):
        S = JS if pkg is J else TS
        xp = jnp if pkg is J else torch
        app.rollback_component("hp", (), xp.int32, checksum=True)
        app.rollback_resource("target_slot", np.int32(-1), checksum=True)

        def step(world, ctx):
            t = world.res["target_slot"]
            hp = world.comps["hp"]
            if pkg is J:
                hit = hp.at[jnp.clip(t, 0, 7)].add(-1)
            else:
                hit = hp - TS.world.slot_mask(8, torch.clamp(t, 0, 7), hp.device).to(torch.int32)
            return dataclasses.replace(world, comps={"hp": xp.where(t >= 0, hit, hp)})

        def setup(world):
            world, _s0 = S.spawn(app.reg, world, {"hp": 100})
            world, s1 = S.spawn(app.reg, world, {"hp": 100})
            return S.insert_resource(app.reg, world, "target_slot", s1)

        app.set_step(step)
        app.set_setup(setup)

    (port, ps), (jr, js) = (_res_run(pkg, build, 10, 4) for pkg in (T, J))
    assert ps == js
    assert int(port.world.comps["hp"][1]) == 90 and int(port.world.comps["hp"][0]) == 100


# -- tests/test_three_peers.py -----------------------------------------------------


def test_three_peer_full_mesh():
    net = ChannelNetwork(latency_hops=1, seed=3)
    names = ["p0", "p1", "p2"]
    socks = [net.endpoint(n) for n in names]
    keys = [box_game.keys_to_input(right=True), box_game.keys_to_input(up=True),
            box_game.keys_to_input(down=True)]
    runners = []
    for i in range(3):
        app = box_game.make_app(num_players=3, device="cpu")
        b = (SessionBuilder.for_app(app).with_input_delay(1)
             .with_disconnect_timeout(60.0).with_disconnect_notify_delay(30.0)
             .add_player(PlayerType.LOCAL, i))
        for j in range(3):
            if j != i:
                b.add_player(PlayerType.REMOTE, j, names[j])
        runners.append(GgrsRunner(app, b.start_p2p_session(socks[i]),
                                  read_inputs=lambda hs, i=i: {h: keys[i] for h in hs}))
    compared = [count_comparisons(r) for r in runners]
    for _ in range(500):
        net.deliver()
        for r in runners:
            r.update(0.0)
        if all(r.session.current_state() == SessionState.RUNNING for r in runners):
            break
        time.sleep(0.001)
    assert all(r.session.current_state() == SessionState.RUNNING for r in runners)
    for _ in range(80):
        net.deliver()
        for r in runners:
            r.update(DT)
    assert all(r.frame >= 70 for r in runners)
    for r in runners:
        assert to_numpy(r.world.comps["pos"])[0, 0] > 1.9
        assert r.session.confirmed_frame() > 50
        assert not desyncs(r)
    f = None
    for _ in range(40):
        conf = min(r.session.confirmed_frame() for r in runners)
        shared = set(runners[0].ring.frames())
        for r in runners[1:]:
            shared &= set(r.ring.frames())
        shared = [fr for fr in shared if fr <= conf]
        if shared:
            f = max(shared)
            break
        net.deliver()
        min(runners, key=lambda r: r.frame).update(DT)
    assert f is not None
    sums = [r.ring.peek(f)[1]() for r in runners]
    assert sums[0] == sums[1] == sums[2], f"3-way desync at {f}: {sums}"
    assert compared == [[], [], []]  # no desync detection configured


# -- tests/test_runner_batching.py ---------------------------------------------------


class ScriptSession(ScriptedSession):
    """Pre-built request lists, one per tick; never confirms, so every load
    target stays legal up to the ring's depth."""

    def local_player_handles(self):
        return []

    def _on_cell_saved(self, frame, provider):
        self.saved.setdefault(frame, []).append(provider)


def gen_script(rng, sess, ticks, reqs):
    Adv, Load, Save, Cell = reqs
    scripts, frame, ring_frames, depth = [], 0, [], 10
    for _ in range(ticks):
        tick = []
        for _ in range(rng.integers(1, 6)):
            op = rng.integers(0, 10)
            if op < 2:
                tick.append(Save(frame, Cell(sess, frame)))
                ring_frames = [f for f in ring_frames if f < frame][-(depth - 1):] + [frame]
            elif op < 4 and ring_frames:
                t = int(ring_frames[rng.integers(0, len(ring_frames))])
                tick.append(Load(t))
                ring_frames = [f for f in ring_frames if f <= t]
                frame = t
            else:
                tick.append(Adv(rng.integers(0, 16, 2).astype(np.uint8), np.zeros(2, np.int8)))
                frame += 1
        scripts.append(tick)
    return scripts


class NaiveRunner:
    """One advance call per request: the semantic reference."""

    def __init__(self, app, session):
        self.app, self.session = app, session
        self.world = app.init_state()
        self.cs = app.checksum_fn(self.world)
        self.ring = SnapshotRing(depth=10)
        self.frame = 0

    def tick(self):
        for r in self.session.advance_frame():
            if isinstance(r, SaveRequest):
                self.ring.push(r.frame, (self.world, self.cs))
                r.cell.save(r.frame, lambda cs=self.cs: checksum_to_int(cs))
            elif isinstance(r, LoadRequest):
                self.world, self.cs = self.ring.rollback(r.frame)
                self.frame = r.frame
            else:
                self.frame += 1
                self.world, self.cs = self.app.advance_fn(self.world, r.inputs, r.status,
                                                          self.frame)


@pytest.mark.parametrize("seed", range(4))
def test_fused_runner_equals_naive_and_jax(seed):
    ticks = 12
    sessions = {}
    for name, reqs in (("fused", (AdvanceRequest, LoadRequest, SaveRequest, SaveCell)),
                       ("naive", (AdvanceRequest, LoadRequest, SaveRequest, SaveCell)),
                       ("jax", (JAdvance, JLoad, JSave, JSaveCell))):
        s = ScriptSession()
        s.script = gen_script(np.random.default_rng(400 + seed), s, ticks, reqs)
        sessions[name] = s
    fused = GgrsRunner(box_game.make_app(device="cpu"), sessions["fused"])
    naive = NaiveRunner(box_game.make_app(device="cpu"), sessions["naive"])
    jr = J.GgrsRunner(j_box_game.make_app(), sessions["jax"], pipeline=False)
    for t in range(ticks):
        fused.tick()
        naive.tick()
        jr.tick()
        assert fused.frame == naive.frame == jr.frame, t
        assert fused._world_checksum() == checksum_to_int(naive.cs), t
        assert fused.ring.frames() == naive.ring.frames() == jr.ring.frames(), t
        for n in fused.world.comps:
            np.testing.assert_allclose(to_numpy(fused.world.comps[n]),
                                       np.asarray(jr.world.comps[n]), rtol=0,
                                       atol=FLOAT_ATOL, err_msg=f"{n} at tick {t}")
    for f in sessions["naive"].saved:
        a = [p() for p in sessions["fused"].saved[f]]
        b = [p() for p in sessions["naive"].saved[f]]
        assert a == b, f"saved checksums differ at frame {f}"
