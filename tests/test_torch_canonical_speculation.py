"""Speculating port peers over the in-memory network, on the CPU.

Mirrors ``tests/test_speculation_network.py``,
``tests/test_canonical_speculation.py`` and ``tests/test_speculation_soak.py``
(both modes, seeds 3 and 11), holding a hedging port peer to a plain peer:

- a hedging peer hits its cache under real network rollbacks and its
  confirmed checksums equal the plain peer's (exact 64-bit equality);
- across packages on ``fixed_point`` (integer math, so bit-identical): a
  speculating port peer against a JAX peer with no cache and
  ``pipeline=False`` (the JAX runner's trusted path, ROADMAP queue C),
  checksums compared every frame, no ``DesyncDetected``;
- canonical-branched: both peers run the one ``[B, K]`` program (the
  hedging peer's hedge lanes fill its cache, the plain peer's lanes copy
  lane 0) over a lossy, jittery channel and stay bit-identical;
- the soak: random held inputs over a lossy channel, a hedging port peer
  against a plain port peer in the fast and canonical-branched modes.
  The JAX soak's fast cases fail for reasons in the JAX pipelined path
  (queue C); the port's pair is held to it on the port's own runner.

Each game is made from its seed (numpy ``default_rng`` inputs, the
channel's seed); only the handshake polls in wall time."""

import dataclasses
import time

import numpy as np
import pytest
import torch

import bevy_ggrs_tpu as J
import bevy_ggrs_tpu_torch as T
from bevy_ggrs_tpu.models import fixed_point as j_fixed_point
from bevy_ggrs_tpu.snapshot.checksum import checksum_to_int as j_checksum_to_int
from bevy_ggrs_tpu_torch import (
    App,
    GgrsRunner,
    SessionState,
    SpeculationConfig,
    pad_candidates,
)
from bevy_ggrs_tpu_torch.models import box_game, fixed_point
from bevy_ggrs_tpu_torch.session.channel import ChannelNetwork
from bevy_ggrs_tpu_torch.session.events import DesyncDetected
from bevy_ggrs_tpu_torch.snapshot import active_mask, spawn

DT = 1.0 / 60.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run this file's small tensors on one intra-op thread: the suite runs
    in several worker processes, and idle OpenMP threads spinning here
    would take cores from the wall-clock-driven games of other files."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _session(pkg, app, i, sock, desync=None, window=None):
    b = (pkg.SessionBuilder.for_app(app).with_input_delay(1)
         .with_disconnect_timeout(60.0).with_disconnect_notify_delay(30.0)
         .add_player(pkg.PlayerType.LOCAL, i)
         .add_player(pkg.PlayerType.REMOTE, 1 - i, "b" if i == 0 else "a"))
    if window is not None:
        b = b.with_max_prediction_window(window)
    if desync is not None:
        b = b.with_desync_detection_mode(pkg.DesyncDetection.on(desync))
    return b.start_p2p_session(sock)


def _sync(net, runners, seconds=30.0):
    deadline = time.monotonic() + seconds
    while time.monotonic() < deadline:
        net.deliver()
        for r in runners:
            r.update(0.0)
        # by value: a JAX session reports the JAX package's enum
        if all(r.session.current_state().value == SessionState.RUNNING.value
               for r in runners):
            return
        time.sleep(0.002)
    raise AssertionError("sessions never synchronized")


def _ring_int(runner, frame):
    ref = runner.ring.peek(frame)[1]
    return ref() if isinstance(runner, GgrsRunner) else j_checksum_to_int(ref)


def _confirmed_common_frame(net, runners, settle_ticks=40):
    """Tick evenly until both rings hold a common confirmed frame; its
    checksums, one per runner."""
    for _ in range(settle_ticks):
        conf = min(r.session.confirmed_frame() for r in runners)
        shared = [f for f in set(runners[0].ring.frames()) & set(runners[1].ring.frames())
                  if f <= conf]
        if shared:
            f = max(shared)
            return f, [_ring_int(r, f) for r in runners]
        net.deliver()
        for r in runners:
            r.update(DT)
    raise AssertionError("peers' rings never shared a confirmed frame")


def _desyncs(runner):
    return [e for e in runner.events if isinstance(e, DesyncDetected)]


# -- tests/test_speculation_network.py ---------------------------------------------


def test_speculating_peer_agrees_with_plain_peer():
    net = ChannelNetwork(latency_hops=3, seed=9)
    socks = [net.endpoint("a"), net.endpoint("b")]
    runners = []
    for i in range(2):
        app = box_game.make_app(num_players=2, device="cpu")
        spec = SpeculationConfig(candidates_fn=pad_candidates(2, [1], list(range(16))),
                                 depth=4) if i == 0 else None
        ticks = [0]

        def read_inputs(handles, i=i, ticks=ticks):
            ticks[0] += 1
            on = (ticks[0] // 5) % 2 == 0  # flip every 5 frames
            key = {0: "right", 1: "up"}[i]
            return {h: box_game.keys_to_input(**{key: on}) for h in handles}

        runners.append(GgrsRunner(app, _session(T, app, i, socks[i], desync=1),
                                  read_inputs=read_inputs, speculation=spec))
    _sync(net, runners)
    for _ in range(120):
        net.deliver()
        for r in runners:
            r.update(DT)
    s0 = runners[0].stats()
    assert s0["rollbacks"] > 0, "latency should have forced rollbacks"
    assert s0["speculation_hits"] > 0 and s0["cache_served_frames"] > 0, s0
    assert s0["donated_dispatches"] == 0
    assert s0["speculation_host_uploads"] == s0["speculation_draft_dispatches"] > 0
    _, (c0, c1) = _confirmed_common_frame(net, runners)
    assert c0 == c1
    assert not _desyncs(runners[0]) and not _desyncs(runners[1])


@pytest.mark.parametrize("port_handle", [0, 1])
def test_speculating_port_peer_agrees_with_jax_plain_peer(port_handle):
    """fixed_point across packages: the port peer hedges the JAX peer's
    flipping input; the JAX peer runs with no cache and pipeline=False."""
    net = ChannelNetwork(latency_hops=3, seed=2)
    socks = [net.endpoint("a"), net.endpoint("b")]
    runners = []
    for i in range(2):
        holder = []

        def read_inputs(handles, i=i, holder=holder):
            on = (holder[0].frame // 7) % 2 == 0 if i != port_handle else True
            return {h: np.uint8(8 if on else 1) for h in handles}

        if i == port_handle:
            app = fixed_point.make_app(device="cpu")
            r = GgrsRunner(app, _session(T, app, i, socks[i], desync=1, window=8),
                           read_inputs=read_inputs, speculation=SpeculationConfig(
                               candidates_fn=pad_candidates(2, [1 - i], [1, 8]), depth=4))
        else:
            app = j_fixed_point.make_app()
            r = J.GgrsRunner(app, _session(J, app, i, socks[i], desync=1, window=8),
                             read_inputs=read_inputs, pipeline=False)
        holder.append(r)
        runners.append(r)
    _sync(net, runners)
    for _ in range(150):
        net.deliver()
        for r in runners:
            r.update(DT)
    for r in runners:
        r.finish()
    port = runners[port_handle]
    assert port.rollbacks > 10 and port.spec_cache.hits > 0
    assert min(r.frame for r in runners) >= 140
    for r in runners:
        assert not [e for e in r.events if type(e).__name__ == "DesyncDetected"]
    shared = sorted(set(runners[0].ring.frames()) & set(runners[1].ring.frames()))
    assert len(shared) >= 2
    for f in shared:
        assert _ring_int(runners[0], f) == _ring_int(runners[1], f), f


# -- tests/test_canonical_speculation.py --------------------------------------------

B, K = 4, 12


def make_canonical_app():
    app = App(num_players=2, capacity=4, input_shape=(), input_dtype=np.uint8,
              canonical_depth=K, canonical_branches=B, device="cpu")
    app.rollback_component("pos", (2,), torch.float32, checksum=True)
    app.rollback_component("handle", (), torch.int32, checksum=True)

    def step(world, ctx):
        h = world.comps["handle"]
        m = active_mask(world) & world.has["handle"]
        v = ctx.inputs.to(torch.float32) / 7.0 - 1.0  # a division
        delta = torch.stack([v, -v], dim=-1)[h.clamp(0, 1).long()]
        pos = world.comps["pos"] + torch.where(m[:, None], delta, 0.0)
        return dataclasses.replace(world, comps={**world.comps, "pos": pos})

    def setup(world):
        for h in range(2):
            world, _ = spawn(app.reg, world, {"pos": np.zeros(2, np.float32), "handle": h})
        return world

    app.set_step(step)
    app.set_setup(setup)
    return app


def test_hedged_and_plain_peers_stay_bit_identical():
    net = ChannelNetwork(latency_hops=3, loss=0.1, jitter_hops=2, seed=5)
    socks = [net.endpoint("a"), net.endpoint("b")]
    runners = []
    for i in range(2):
        app = make_canonical_app()
        # only peer 0 hedges; peer 1 runs the same program with copied lanes
        spec = SpeculationConfig(
            candidates_fn=lambda used: np.arange(B - 1, dtype=np.uint8)[:, None].repeat(2, 1),
        ) if i == 0 else None
        tick = [0]

        def read_inputs(handles, tick=tick):
            tick[0] += 1
            return {h: np.uint8((tick[0] // 6) % 3) for h in handles}  # hedged values

        runners.append(GgrsRunner(app, _session(T, app, i, socks[i]),
                                  read_inputs=read_inputs, speculation=spec))
    assert not runners[0].packed and runners[1].app.packed_resim_fn is None
    _sync(net, runners, seconds=20.0)
    for _ in range(150):
        net.deliver()
        for r in runners:
            r.update(DT)
    s0 = runners[0].stats()
    assert s0["rollbacks"] > 0
    assert s0["speculation_hits"] > 0, f"hedging never hit: {s0}"
    assert s0["speculation_draft_dispatches"] == 0  # hedges ride the branched lanes
    assert s0["host_uploads"] == s0["device_dispatches"]  # one [B, K + 1, W] upload each
    # the plain peer runs the same dispatch, with copies of lane 0 for hedges
    assert runners[1].spec_cache is None and runners[1].stats()["host_uploads"] == \
        runners[1].stats()["device_dispatches"]
    f, (c0, c1) = _confirmed_common_frame(net, runners)
    assert c0 == c1, f"hedged peer diverged from plain peer at frame {f}"


# -- tests/test_speculation_soak.py ---------------------------------------------------


def _run_soak(mode: str, seed: int, ticks: int = 250):
    net = ChannelNetwork(latency_hops=2, loss=0.1, seed=seed, jitter_hops=2)
    socks = [net.endpoint("a"), net.endpoint("b")]
    rngs = [np.random.default_rng(1000 * seed + i) for i in range(2)]
    runners = []
    for i in range(2):
        app = box_game.make_app(num_players=2, device="cpu")
        if mode == "canonical-branched":
            app.canonical_depth = 10
            app.canonical_branches = 9  # lane 0 + all 8 hedge candidates
        spec = SpeculationConfig(candidates_fn=pad_candidates(2, [1 - i], list(range(8))),
                                 depth=4) if i == 0 else None

        def read_inputs(handles, i=i):
            return {h: np.uint8(rngs[i].integers(0, 8)) for h in handles}

        runners.append(GgrsRunner(app, _session(T, app, i, socks[i], window=8),
                                  read_inputs=read_inputs, speculation=spec))
    _sync(net, runners)
    dt_rng = np.random.default_rng(seed)
    for _ in range(ticks):
        net.deliver()
        for r in runners:
            r.update(DT * float(dt_rng.uniform(0.5, 1.5)))
    return net, runners


@pytest.mark.parametrize("mode", ["fast", "canonical-branched"])
@pytest.mark.parametrize("seed", [3, 11])
def test_hedging_peer_bit_identical_to_plain_peer(mode, seed):
    net, runners = _run_soak(mode, seed)
    assert all(r.frame > 100 for r in runners)
    common = ()
    for _ in range(120):
        net.deliver()
        for r in runners:
            r.update(DT)
        confirmed = min(r.confirmed for r in runners)
        common = [f for f in sorted(set(runners[0].ring.frames())
                                    & set(runners[1].ring.frames())) if f <= confirmed]
        if common:
            break
    assert common, "peers' snapshot rings never overlapped"
    cs = [_ring_int(r, common[-1]) for r in runners]
    assert cs[0] == cs[1], f"speculating and plain peers diverged ({mode}, seed {seed})"
    stats = runners[0].stats()
    assert stats["speculation_hits"] + stats["speculation_misses"] > 0
    assert stats["speculation_hits"] > 0  # hedging engaged and served


def test_speculating_pair_under_desync_detection_never_desyncs():
    """Both peers hedge, checksums compared every frame over a lossy
    channel: no DesyncDetected on either side."""
    net = ChannelNetwork(latency_hops=3, loss=0.05, jitter_hops=1, seed=4)
    socks = [net.endpoint("a"), net.endpoint("b")]
    runners = []
    for i in range(2):
        app = box_game.make_app(num_players=2, device="cpu")
        holder = []

        def read_inputs(handles, i=i, holder=holder):
            on = (holder[0].frame // 5) % 2 == 0
            return {h: box_game.keys_to_input(right=on, up=i == 1) for h in handles}

        r = GgrsRunner(app, _session(T, app, i, socks[i], desync=1),
                       read_inputs=read_inputs, speculation=SpeculationConfig(
                           candidates_fn=pad_candidates(2, [1 - i], [0, 1, 8, 9]),
                           depth=3, max_cached_frames=8))
        holder.append(r)
        runners.append(r)
    _sync(net, runners)
    for _ in range(150):
        net.deliver()
        for r in runners:
            r.update(DT)
    for r in runners:
        r.finish()
        assert not _desyncs(r)
        assert r.spec_cache.hits > 0
    _, (c0, c1) = _confirmed_common_frame(net, runners)
    assert c0 == c1
