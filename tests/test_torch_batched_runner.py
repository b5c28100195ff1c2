"""The port's BatchedRunner (many lobbies, one call per wave), held
against M solo port runners and against the JAX package's BatchedRunner.

Mirrors the runner tests of ``tests/test_batched_runner.py`` (the two
executor tests are in ``test_torch_batch.py``): SyncTest lobbies equal
their solo runners checksum for checksum with the SyncTest oracle green
inside the batch; dispatches per tick bounded and flat in the lobby
count; mixed-source load waves served by one fused gather; both peers of
a P2P game as two lanes; a quantized (non-identity) strategy through the
stored-stack saves; the canonical refusal; staggered P2P rollback waves.
Besides: the packed wave's staging bytes equal the JAX runner's byte for
byte, tick by tick; the wave and load counters and the bucket histogram
equal the JAX runner's on the same traffic; P2P lobbies' confirmed
checksums equal the same pairs on solo runners; the unpacked and the
synchronous modes equal the default.

Checksums, ids and counters exact; the JAX side runs with
``pipeline=False``, whose results are trusted (ROADMAP queue C)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bevy_ggrs_tpu as J
import bevy_ggrs_tpu.snapshot as JS
import bevy_ggrs_tpu_torch as T
import bevy_ggrs_tpu_torch.snapshot as TS
from bevy_ggrs_tpu.models import fixed_point as j_fixed_point
from bevy_ggrs_tpu.models import stress as j_stress
from bevy_ggrs_tpu_torch import BatchedRunner, GgrsRunner, PlayerType, SessionBuilder
from bevy_ggrs_tpu_torch.models import fixed_point, stress
from bevy_ggrs_tpu_torch.session.channel import ChannelNetwork
from bevy_ggrs_tpu_torch.utils.frames import frame_le


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _session(pkg=T, check_distance=4, **kw):
    kw.setdefault("compare_interval", 1)
    return pkg.SyncTestSession(num_players=2, input_shape=(), input_dtype=np.uint8,
                               check_distance=check_distance, **kw)


def _lobby_inputs(lobby, tick, handles):
    rng = np.random.default_rng(1000 * lobby + tick)
    return {h: np.uint8(rng.integers(0, 16)) for h in handles}


def _lobby_inputs_tickless(lobby, handles):
    rng = np.random.default_rng(lobby)
    return {h: np.uint8(rng.integers(0, 16)) for h in handles}


def run_batched(pkg, app, sessions, ticks, **kw):
    """Tick a BatchedRunner ``ticks`` times on the per-(lobby, tick) input
    stream; returns ``(runner, per-lobby live checksum streams)``."""
    tcount = [0]
    if pkg is J:
        kw.setdefault("pipeline", False)
    br = pkg.BatchedRunner(app, sessions, read_inputs=lambda b, hs: _lobby_inputs(
        b, tcount[0], hs), **kw)
    streams = [[] for _ in sessions]
    for _ in range(ticks):
        br.tick()
        tcount[0] += 1
        for b in range(len(sessions)):
            streams[b].append(br.lobby_checksum(b))
    br.finish()  # the SyncTest oracle: raises on any batched-restore mismatch
    return br, streams


def solo_stream(app, lobby, session, ticks):
    t = [0]

    def read_inputs(handles):
        out = _lobby_inputs(lobby, t[0], handles)
        t[0] += 1
        return out

    runner = GgrsRunner(app, session, read_inputs=read_inputs)
    out = []
    for _ in range(ticks):
        runner.tick()
        out.append(runner.checksum)
    runner.finish()
    return out


MODELS = {
    "stress": (lambda: stress.make_app(128, capacity=128, device="cpu"),
               lambda: j_stress.make_app(128, capacity=128), False),
    "fixed_point": (lambda: fixed_point.make_app(device="cpu"), j_fixed_point.make_app, True),
}


@pytest.mark.parametrize("model", list(MODELS))
def test_batched_runner_matches_independent_runners(model):
    make, jmake, exact = MODELS[model]
    m, ticks = 3, 25
    br, batched = run_batched(T, make(), [_session() for _ in range(m)], ticks)
    for b in range(m):
        assert batched[b] == solo_stream(make(), b, _session(), ticks), f"lobby {b}"
    jbr, jbatched = run_batched(J, jmake(), [_session(J) for _ in range(m)], ticks)
    if exact:  # an integer model: the JAX lobbies' streams, bit for bit
        assert batched == jbatched
    for b in range(m):
        got, want = br.lobby_world(b), jbr.lobby_world(b)
        for n in got.comps:
            np.testing.assert_allclose(got.comps[n].numpy(), np.asarray(want.comps[n]),
                                       rtol=0, atol=0 if exact else 1e-4, err_msg=n)
    st, jst = br.stats(), jbr.stats()
    for key in ("bucket_hist", "wave_dispatches", "device_dispatches", "fused_loads",
                "fallback_loads", "rollbacks", "frames"):
        assert st[key] == jst[key], key


def test_batched_runner_dispatch_count():
    """M lobbies per tick cost O(waves) dispatches, not O(M): the warmed-up
    SyncTest shape is 3 per tick (one fused load wave, two run waves)."""
    m, ticks = 8, 12
    br = BatchedRunner(stress.make_app(64, capacity=64, device="cpu"),
                       [_session(check_distance=3) for _ in range(m)],
                       read_inputs=_lobby_inputs_tickless)
    for _ in range(ticks):
        br.tick()
    br.finish()
    s = br.stats()
    assert s["device_dispatches"] <= 3 * ticks, s
    assert s["fallback_loads"] == 0, s
    assert all(f == ticks for f in s["frames"]), s


def test_batched_runner_dispatches_flat_in_lobby_count():
    """The same lockstep workload at M=4 and M=16 costs the same number of
    device dispatches, as in the JAX runner."""
    per_m = {}
    for m in (4, 16):
        for pkg, make in ((T, lambda: stress.make_app(64, capacity=64, device="cpu")),
                          (J, lambda: j_stress.make_app(64, capacity=64))):
            kw = {"pipeline": False} if pkg is J else {}
            br = pkg.BatchedRunner(make(), [_session(pkg, check_distance=2) for _ in range(m)],
                                   read_inputs=_lobby_inputs_tickless, **kw)
            for _ in range(10):
                br.tick()
            br.finish()
            per_m[(pkg.__name__, m)] = br.stats()["device_dispatches"]
    assert per_m[(T.__name__, 4)] == per_m[(T.__name__, 16)] == per_m[(J.__name__, 4)], per_m


def test_batched_runner_mixed_source_loads_match_solo():
    """Per-lobby check distances and compare intervals make every load wave
    mixed: lobbies load rows of different past stacks, one lobby only every
    other tick; the whole wave is still one fused gather and each lobby
    equals its solo runner and the JAX batched lobby."""
    configs = [dict(check_distance=4, compare_interval=1),
               dict(check_distance=2, compare_interval=1),
               dict(check_distance=3, compare_interval=2)]
    ticks = 25
    br, batched = run_batched(T, fixed_point.make_app(device="cpu"),
                              [_session(**c) for c in configs], ticks)
    s = br.stats()
    assert s["fallback_loads"] == 0 and s["fused_loads"] > 0, s
    for b, cfg in enumerate(configs):
        assert batched[b] == solo_stream(fixed_point.make_app(device="cpu"), b,
                                         _session(**cfg), ticks), f"lobby {b}"
    _jbr, jbatched = run_batched(J, j_fixed_point.make_app(),
                                 [_session(J, **c) for c in configs], ticks)
    assert batched == jbatched
    # the mix really happened: some load waves covered only part of the lobbies
    load_waves, tcount = [], [0]
    br2 = BatchedRunner(fixed_point.make_app(device="cpu"), [_session(**c) for c in configs],
                        read_inputs=lambda b, hs: _lobby_inputs(b, tcount[0], hs))
    orig_do_loads = br2._do_loads

    def spying_do_loads(wave_ops, *args):
        n = sum(1 for op in wave_ops if op is not None and op.load_frame is not None)
        if n:
            load_waves.append(n)
        return orig_do_loads(wave_ops, *args)

    br2._do_loads = spying_do_loads
    for _ in range(ticks):
        br2.tick()
        tcount[0] += 1
    assert any(0 < n < len(configs) for n in load_waves), load_waves


def _p2p_sessions(pkg, net, games, window=8, latency=None, flip=None):
    sessions = []
    for g in range(games):
        for i in range(2):
            app_mod = fixed_point if pkg is T else j_fixed_point
            kw = {"device": "cpu"} if pkg is T else {}
            b = (pkg.SessionBuilder.for_app(app_mod.make_app(**kw)).with_input_delay(1)
                 .with_max_prediction_window(window)
                 .add_player(pkg.PlayerType.LOCAL, i)
                 .add_player(pkg.PlayerType.REMOTE, 1 - i, f"g{g}p{1 - i}"))
            sessions.append(b.start_p2p_session(net[g].endpoint(f"g{g}p{i}")))
    return sessions


def _sync(nets, tick, sessions):
    for _ in range(400):
        for net in nets:
            net.deliver()
        tick()
        if all(s.current_state().value == "running" for s in sessions):
            return
    raise AssertionError("sessions never synchronized")


def test_batched_runner_p2p_pair_in_one_batch():
    """Both peers of ONE P2P game as two lanes of the same batch."""
    app = stress.make_app(64, capacity=64, device="cpu")
    net = ChannelNetwork(latency_hops=1)
    sessions = []
    for i in range(2):
        b = (SessionBuilder.for_app(app).with_input_delay(1)
             .add_player(PlayerType.LOCAL, i)
             .add_player(PlayerType.REMOTE, 1 - i, "b" if i == 0 else "a"))
        sessions.append(b.start_p2p_session(net.endpoint("a" if i == 0 else "b")))
    br = BatchedRunner(app, sessions,
                       read_inputs=lambda lobby, hs: {h: np.uint8((lobby * 7 + h * 3) & 0xF)
                                                      for h in hs})
    _sync([net], br.tick, sessions)
    for _ in range(60):
        net.deliver()
        br.tick()
    s = br.stats()
    assert min(s["frames"]) > 40, s
    if s["frames"][0] == s["frames"][1]:
        assert br.lobby_checksum(0) == br.lobby_checksum(1)


def quantized_app(pkg):
    S = JS if pkg is J else TS
    xp = jnp if pkg is J else torch
    kw = {} if pkg is J else {"device": "cpu"}
    app = pkg.App(num_players=1, capacity=4, input_shape=(), input_dtype=np.uint8, **kw)
    app.rollback_component("x", (), xp.float32, strategy=pkg.QuantizeStrategy(),
                           checksum=True)
    app.rollback_component("n", (), xp.int32, checksum=True)

    def step(world, ctx):
        m = S.active_mask(world)
        c = world.comps
        return dataclasses.replace(world, comps={
            "x": xp.where(m & world.has["x"], c["x"] * np.float32(1.001) + np.float32(0.01),
                          c["x"]),
            "n": xp.where(m & world.has["n"], c["n"] + 1, c["n"]),
        })

    def setup(world):
        world, _ = S.spawn(app.reg, world, {"x": 0.3, "n": 0})
        return world

    app.set_step(step)
    app.set_setup(setup)
    return app


def test_batched_runner_non_identity_fused_saves_match_solo():
    """A quantized bf16 column under batched SyncTest with mixed rollback
    depths: the saves go through one stored stack per wave, the loads
    through the fused gather with ``load_state``, and every lobby equals
    its solo runner (the per-frame round trip makes the stored form
    canonical, so the comparison is exact)."""
    cds, ticks = [3, 2, 3], 15

    def sess(pkg, cd):
        return pkg.SyncTestSession(num_players=1, input_shape=(), input_dtype=np.uint8,
                                   check_distance=cd, compare_interval=1)

    zero = lambda *a: {h: np.uint8(0) for h in a[-1]}  # noqa: E731
    br = BatchedRunner(quantized_app(T), [sess(T, cd) for cd in cds], read_inputs=zero)
    batched = [[] for _ in cds]
    for _ in range(ticks):
        br.tick()
        for b in range(len(cds)):
            batched[b].append(br.lobby_checksum(b))
    br.finish()
    assert br.stats()["fallback_loads"] == 0
    for b, cd in enumerate(cds):
        runner = GgrsRunner(quantized_app(T), sess(T, cd), read_inputs=zero)
        solo = []
        for _ in range(ticks):
            runner.tick()
            solo.append(runner.checksum)
        assert batched[b] == solo, f"lobby {b}"
    jbr = J.BatchedRunner(quantized_app(J), [sess(J, cd) for cd in cds], read_inputs=zero,
                          pipeline=False)
    for _ in range(ticks):
        jbr.tick()
    for b in range(len(cds)):
        got, want = br.lobby_world(b), jbr.lobby_world(b)
        assert np.array_equal(got.comps["n"].numpy(), np.asarray(want.comps["n"]))
        np.testing.assert_allclose(got.comps["x"].numpy(), np.asarray(want.comps["x"]),
                                   rtol=0, atol=1e-4)


def test_batched_runner_rejects_canonical_mode():
    app = stress.make_app(64, capacity=64, device="cpu")
    app.canonical_depth = 8
    with pytest.raises(ValueError, match="canonical mode"):
        BatchedRunner(app, [_session()])
    with pytest.raises(ValueError, match="mesh"):
        BatchedRunner(stress.make_app(64, capacity=64, device="cpu"), [_session()],
                      mesh=object())


def test_batched_runner_staggered_p2p_rollback_waves():
    """Several P2P games in ONE batch, each over a channel with its own
    latency and jitter and a flip period of its own, so rollback waves hit
    different lobbies on different ticks and load waves are partial; the
    two lanes of every game agree at every mutually confirmed ring frame."""
    games = 3
    nets = [ChannelNetwork(latency_hops=1 + g, jitter_hops=g, seed=100 + g)
            for g in range(games)]
    sessions = _p2p_sessions(T, nets, games)
    tick_no = [0]

    def read_inputs(lobby, handles):
        on = (tick_no[0] // (4 + 2 * (lobby // 2))) % 2 == 0
        return {h: np.uint8(0x3 if on else 0xC) for h in handles}

    br = BatchedRunner(fixed_point.make_app(device="cpu"), sessions, read_inputs=read_inputs)
    wave_profile = []
    orig_do_loads = br._do_loads

    def spying_do_loads(wave_ops, *args):
        n = sum(1 for op in wave_ops if op is not None and op.load_frame is not None)
        if n:
            wave_profile.append(n)
        return orig_do_loads(wave_ops, *args)

    br._do_loads = spying_do_loads

    seen = [{} for _ in sessions]

    def drive(n):
        for _ in range(n):
            tick_no[0] += 1
            for net in nets:
                net.deliver()
            br.tick()
            _confirmed(br.rings, br.confirmed, seen)

    _sync(nets, br.tick, sessions)
    drive(120)
    s = br.stats()
    assert min(s["frames"]) > 80 and br.rollbacks > 0, s
    assert wave_profile and any(n < 2 * games for n in wave_profile), wave_profile
    # the two lanes of every game agree at every frame both confirmed (the
    # reference reads the rings' overlap at the end, which the lanes'
    # handshake lag can leave empty; this records each confirmed frame)
    for g in range(games):
        a, b = 2 * g, 2 * g + 1
        shared = set(seen[a]) & set(seen[b])
        assert len(shared) > 40, (g, len(shared))
        for f in sorted(shared):
            assert seen[a][f]() == seen[b][f](), (g, f)
    assert not [e for _b, e in br.events if type(e).__name__ == "DesyncDetected"]


# -- beyond the reference's tests ------------------------------------------------------


def test_packed_wave_bytes_equal_jax_runner():
    """The packed staging buffer, prefix rows included, byte for byte the
    JAX runner's after every tick, on SyncTest lobbies at spread depths."""
    configs = [dict(check_distance=2), dict(check_distance=4), dict(check_distance=3)]
    tcount = [0]
    kw = dict(read_inputs=lambda b, hs: _lobby_inputs(b, tcount[0], hs))
    br = BatchedRunner(fixed_point.make_app(device="cpu"), [_session(**c) for c in configs], **kw)
    jbr = J.BatchedRunner(j_fixed_point.make_app(), [_session(J, **c) for c in configs],
                          pipeline=False, **kw)
    for _ in range(12):
        br.tick()
        jbr.tick()
        tcount[0] += 1
        assert br._stage_packed.tobytes() == np.asarray(jbr._stage_packed).tobytes()
    assert br.stats()["host_uploads"] == br.stats()["wave_dispatches"]


@pytest.mark.parametrize("mode", ["unpacked", "sync"])
def test_batched_runner_modes_equal_the_default(mode):
    kw = {"packed": False} if mode == "unpacked" else {"pipeline": False}
    configs = [dict(check_distance=4), dict(check_distance=2)]
    _br, default = run_batched(T, fixed_point.make_app(device="cpu"),
                               [_session(**c) for c in configs], 14)
    br, other = run_batched(T, fixed_point.make_app(device="cpu"),
                            [_session(**c) for c in configs], 14, **kw)
    assert other == default
    st = br.stats()
    assert st["host_uploads"] == (3 if mode == "unpacked" else 1) * st["wave_dispatches"]


def _confirmed(rings, conf, seen):
    """Record each lobby's ring checksum refs at frames it has confirmed."""
    for b, ring in enumerate(rings):
        for f in ring.frames():
            if frame_le(f, conf[b]):
                seen[b].setdefault(f, ring.peek(f)[1])


def test_p2p_lobbies_equal_solo_pairs():
    """Staggered P2P games in one BatchedRunner against the same games on
    solo runners: inputs are functions of the frame, so every confirmed
    checksum must agree whatever the network's timing."""
    games, frames = 2, 90

    def inputs(frame, lobby):
        on = (frame // (5 + 2 * (lobby // 2))) % 2 == 0 if lobby % 2 == 0 else True
        return np.uint8(8 if on else 1)

    nets = [ChannelNetwork(latency_hops=3, seed=7 + g) for g in range(games)]
    sessions = _p2p_sessions(T, nets, games)
    br = BatchedRunner(fixed_point.make_app(device="cpu"), sessions,
                       read_inputs=lambda b, hs: {h: inputs(br.frames[b], b) for h in hs})
    _sync(nets, br.tick, sessions)
    seen_b = [{} for _ in sessions]
    for _ in range(frames):
        for net in nets:
            net.deliver()
        br.tick()
        _confirmed(br.rings, br.confirmed, seen_b)
    assert br.rollbacks > 0 and br.stats()["fallback_loads"] == 0
    solo_nets = [ChannelNetwork(latency_hops=3, seed=7 + g) for g in range(games)]
    solo_sessions = _p2p_sessions(T, solo_nets, games)
    runners = []
    for b, s in enumerate(solo_sessions):
        holder = []
        runners.append(GgrsRunner(fixed_point.make_app(device="cpu"), s,
                                  read_inputs=lambda hs, b=b, holder=holder: {
                                      h: inputs(holder[0].frame, b) for h in hs}))
        holder.append(runners[-1])

    def tick_all():
        for r in runners:
            r.update(1.0 / 60.0)

    _sync(solo_nets, lambda: [r.update(0.0) for r in runners], solo_sessions)
    seen_s = [{} for _ in runners]
    for _ in range(frames):
        for net in solo_nets:
            net.deliver()
        tick_all()
        _confirmed([r.ring for r in runners], [r.confirmed for r in runners], seen_s)
    compared = 0
    for b in range(len(sessions)):
        shared = set(seen_b[b]) & set(seen_s[b])
        assert len(shared) > frames // 2, (b, len(shared))
        for f in shared:
            assert seen_b[b][f]() == seen_s[b][f](), (b, f)
            compared += 1
    assert compared > 0


def test_batched_runner_ops_per_tick_flat_in_lobby_count():
    """The CPU's view of the card's launch count: the torch ops a steady
    SyncTest tick executes (counted below ``vmap``, as they run) are the
    same at M=4 and M=16 lobbies."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops += 1
            return func(*args, **(kwargs or {}))

    per_m = {}
    for m in (4, 16):
        br = BatchedRunner(stress.make_app(64, capacity=64, device="cpu"),
                           [_session(check_distance=2) for _ in range(m)],
                           read_inputs=_lobby_inputs_tickless)
        for _ in range(4):
            br.tick()
        with Count() as counter:
            for _ in range(6):
                br.tick()
        per_m[m] = counter.ops
    assert per_m[4] == per_m[16] > 0, per_m
