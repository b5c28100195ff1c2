"""The device-resident megastep on the port (``ops/megastep.py`` and
``GgrsRunner(megastep=True)``), held bit for bit against the port's own
per-tick driver, and against the JAX runner with ``pipeline=False``.

- Mirrors of ``tests/test_megastep.py`` (5): SyncTest (a load every tick,
  fused from the device ring), coalesced flushes, the steady P2P shape (N
  coalesced frames = 1 dispatch + 1 upload), P2P with rollbacks against a
  per-tick partner, and the construction guards (with the identity
  strategy's refusal the JAX test does not reach).
- The port's models (particles, crowd, pong) in SyncTest and coalesced
  runs, megastep on against off; a session that crosses I32_MAX.
- The program alone: the ring writeback (padded rows to the trash row,
  slots by ``torch.remainder`` of wrapped frames), a fused load against a
  host load, and aliasing: no returned tensor shares storage with the
  ring, and a load whose slot the very next call overwrites leaves the
  first call's outputs intact.
- The same SyncTest game on the JAX runner (``pipeline=False``, megastep
  on): equal checksums, fused loads on both sides."""

import numpy as np
import pytest
import torch

import bevy_ggrs_tpu as J
from bevy_ggrs_tpu.models import fixed_point as j_fixed_point
from bevy_ggrs_tpu_torch import (
    GgrsRunner,
    PlayerType,
    QuantizeStrategy,
    SessionBuilder,
    SessionState,
    SpeculationConfig,
    SyncTestSession,
)
from bevy_ggrs_tpu_torch.models import crowd, fixed_point, particles, pong, stress, stress_soa
from bevy_ggrs_tpu_torch.ops.megastep import init_device_ring, make_megastep_fn
from bevy_ggrs_tpu_torch.ops.packing import pack_prefix, pack_row, repeat_last_row
from bevy_ggrs_tpu_torch.ops.resim import resim_padded
from bevy_ggrs_tpu_torch.session.channel import ChannelNetwork
from bevy_ggrs_tpu_torch.utils.frames import I32_MAX, frame_add, frame_lt
from bevy_ggrs_tpu_torch.utils.tree import tree_flatten

DT = 1.0 / 60.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def cs(entry) -> int:
    return entry[1]()


def _drive(megastep, coalesce=1, ticks=36, chunk=1, check_distance=3, make=None,
           initial_frame=0):
    app = (make or (lambda: fixed_point.make_app(device="cpu")))()
    session = SyncTestSession(num_players=2, input_shape=(), input_dtype=np.uint8,
                              check_distance=check_distance, compare_interval=1,
                              initial_frame=initial_frame)
    t = [0]

    def read_inputs(handles):
        t[0] += 1
        return {h: np.uint8((t[0] * 7 + h * 3) & 0xF) for h in handles}

    runner = GgrsRunner(app, session, read_inputs=read_inputs,
                        on_mismatch=lambda e: (_ for _ in ()).throw(e),
                        coalesce_frames=coalesce, megastep=megastep)
    done = 0
    while done < ticks:
        n = min(chunk, ticks - done)
        runner.update(n * DT)
        done += n
    runner.finish()
    return runner


def _assert_bit_identical(a, b):
    assert a.frame == b.frame
    assert a.checksum == b.checksum
    shared = sorted(set(a.ring.frames()) & set(b.ring.frames()))
    assert shared
    for f in shared:
        assert cs(a.ring.peek(f)) == cs(b.ring.peek(f))


# -- tests/test_megastep.py ------------------------------------------------------


def test_megastep_synctest_bit_identical():
    ms = _drive(megastep=True)
    ref = _drive(megastep=False)
    _assert_bit_identical(ms, ref)
    st = ms.stats()
    assert st["megastep"] and st["fused_ring_loads"] > 0
    assert st["megastep_dispatches"] > 0
    assert st["host_uploads"] == st["device_dispatches"]


def test_megastep_coalesced_bit_identical():
    ms = _drive(megastep=True, coalesce=8, ticks=48, chunk=8, check_distance=8)
    ref = _drive(megastep=False, coalesce=8, ticks=48, chunk=8, check_distance=8)
    _assert_bit_identical(ms, ref)
    st = ms.stats()
    assert st["fused_ring_loads"] > 0
    assert st["host_uploads"] == st["device_dispatches"]
    assert st["device_dispatches"] <= ref.stats()["device_dispatches"]


def _p2p_pair(coalesce, megastep):
    net = ChannelNetwork(seed=21)
    socks = [net.endpoint(f"m{i}") for i in range(2)]
    runners = []
    for i in range(2):
        app = fixed_point.make_app(device="cpu")
        b = (SessionBuilder.for_app(app).with_input_delay(2)
             .add_player(PlayerType.LOCAL, i).add_player(PlayerType.REMOTE, 1 - i, f"m{1 - i}"))
        runners.append(GgrsRunner(
            app, b.start_p2p_session(socks[i]),
            read_inputs=lambda hs: {h: np.uint8(3) for h in hs},
            coalesce_frames=coalesce, megastep=megastep))
    for _ in range(500):
        net.deliver()
        for r in runners:
            r.update(0.0)
        if all(r.session.current_state() == SessionState.RUNNING for r in runners):
            break
    assert all(r.session.current_state() == SessionState.RUNNING for r in runners)
    return net, runners


def test_megastep_steady_p2p_one_dispatch_per_n_ticks():
    n = 8
    net, runners = _p2p_pair(coalesce=n, megastep=True)
    for _ in range(6):
        net.deliver()
        for r in runners:
            r.update(n * DT)
    r0 = runners[0]
    rb0 = r0.rollbacks
    flushes, exact = 10, 0
    for _ in range(flushes):
        d0, u0, f0 = r0.resims, r0.stats()["host_uploads"], r0.frame
        net.deliver()
        for r in runners:
            r.update(n * DT)
        if r0.frame - f0 == n:
            assert r0.resims - d0 == 1
            assert r0.stats()["host_uploads"] - u0 == 1
            exact += 1
    assert exact >= flushes // 2
    assert r0.rollbacks == rb0
    for _ in range(200):
        if runners[0].frame == runners[1].frame:
            break
        net.deliver()
        min(runners, key=lambda r: r.frame).update(DT)
    assert runners[0].frame == runners[1].frame
    assert runners[0].checksum == runners[1].checksum
    for r in runners:
        r.finish()


def _flip_pair(make_app, seed=5, modes=((True, 4), (False, 1))):
    net = ChannelNetwork(latency_hops=3, seed=seed)
    socks = [net.endpoint(f"x{i}") for i in range(2)]
    runners = []
    for i, (ms, co) in enumerate(modes):
        app = make_app()
        b = (SessionBuilder.for_app(app).with_input_delay(1)
             .add_player(PlayerType.LOCAL, i).add_player(PlayerType.REMOTE, 1 - i, f"x{1 - i}"))
        flip = [0]

        def read_inputs(hs, flip=flip, i=i):
            flip[0] += 1
            return {h: np.uint8((flip[0] // 5 + i) & 0x7) for h in hs}

        runners.append(GgrsRunner(app, b.start_p2p_session(socks[i]),
                                  read_inputs=read_inputs, coalesce_frames=co,
                                  megastep=ms))
    for _ in range(500):
        net.deliver()
        for r in runners:
            r.update(0.0)
        if all(r.session.current_state() == SessionState.RUNNING for r in runners):
            break
    for step in range(120):
        net.deliver()
        runners[1].update(DT)
        if step % 4 == 3:
            runners[0].update(4 * DT)
    shared = []
    for _ in range(40):
        net.deliver()
        for r in runners:
            r.update(DT)
        horizon = min(r.confirmed for r in runners)
        shared = sorted(f for f in set(runners[0].ring.frames()) & set(runners[1].ring.frames())
                        if not frame_lt(horizon, f))
        if shared:
            break
    for r in runners:
        r.finish()
    return runners, shared


def test_megastep_p2p_with_rollbacks_matches_per_tick_driver():
    runners, shared = _flip_pair(lambda: fixed_point.make_app(device="cpu"))
    assert runners[0].rollbacks > 0, "latency never forced a rollback"
    assert runners[0].fused_ring_loads > 0
    assert shared
    for f in shared:
        assert cs(runners[0].ring.peek(f)) == cs(runners[1].ring.peek(f))


def test_megastep_construction_guards():
    app = fixed_point.make_app(device="cpu")

    def sess():
        return SyncTestSession(num_players=2, input_shape=(), input_dtype=np.uint8,
                               check_distance=3, compare_interval=1)

    with pytest.raises(ValueError, match="mutually exclusive"):
        GgrsRunner(app, sess(), megastep=True, speculation=SpeculationConfig(
            candidates_fn=lambda used: used[None], depth=1))
    capp = stress.make_app(64, capacity=64, device="cpu")
    capp.canonical_depth = 8
    capp.canonical_branches = 4
    with pytest.raises(ValueError, match="canonical_branches"):
        GgrsRunner(capp, sess(), megastep=True)
    qapp = stress_soa.make_app(64, device="cpu", strategy=QuantizeStrategy())
    with pytest.raises(ValueError, match="identity snapshot strategy"):
        GgrsRunner(qapp, sess(), megastep=True)
    # and the JAX runner refuses the same three
    with pytest.raises(ValueError, match="mutually exclusive"):
        J.GgrsRunner(j_fixed_point.make_app(), J.SyncTestSession(
            num_players=2, input_shape=(), input_dtype=np.uint8, check_distance=3),
            megastep=True, speculation=J.SpeculationConfig(
                candidates_fn=lambda used: used[None], depth=1))
    assert GgrsRunner(app, sess(), megastep=True).enable_donation is False


# -- the port's models, megastep on against off ----------------------------------------


MODELS = {
    "particles": lambda: particles.make_app(rate=4, ttl=6, capacity=96, device="cpu"),
    "crowd": lambda: crowd.make_app(n_per_team=16, device="cpu"),
    "pong": lambda: pong.make_app(device="cpu"),
}


@pytest.mark.parametrize("model", list(MODELS))
@pytest.mark.parametrize("coalesce", [1, 4])
def test_models_synctest_megastep_equals_per_tick(model, coalesce):
    kw = dict(coalesce=coalesce, ticks=40, chunk=coalesce,
              check_distance=3 if coalesce == 1 else 4, make=MODELS[model])
    ms, ref = _drive(megastep=True, **kw), _drive(megastep=False, **kw)
    _assert_bit_identical(ms, ref)
    assert ms.fused_ring_loads > 0
    for a, b in zip(tree_flatten(ms.world), tree_flatten(ref.world)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("model", list(MODELS))
def test_models_p2p_with_rollbacks_megastep_equals_per_tick(model):
    runners, shared = _flip_pair(MODELS[model], seed=9)
    assert runners[0].rollbacks > 0 and shared
    for f in shared:
        assert cs(runners[0].ring.peek(f)) == cs(runners[1].ring.peek(f))


@pytest.mark.parametrize("coalesce", [1, 8])
def test_megastep_across_i32_max(coalesce):
    """Across the wrap ``f mod R`` jumps by ``2**32 mod R``: at coalesce 8
    (R = 18) two frames 4 apart share a slot inside one call; the host
    mirror forgets such a slot, so no load reads a row the device may not
    have kept."""
    kw = dict(ticks=24, chunk=coalesce, coalesce=coalesce, initial_frame=I32_MAX - 9,
              check_distance=3 if coalesce == 1 else 8)
    ms, ref = _drive(megastep=True, **kw), _drive(megastep=False, **kw)
    _assert_bit_identical(ms, ref)
    assert ms.frame < 0 and ms.fused_ring_loads > 0
    # the host mirror and the device tags agree slot for slot
    tags = ms._ms_ring_frames.tolist()
    for slot, f in ms._dev_frames.items():
        assert tags[slot] == f and ms._dev_slot(f) == slot


# -- the program alone -----------------------------------------------------------------


def _packed(app, k_max, start, inputs, has_load=0, load_slot=0):
    spec = app.packed_spec
    buf = spec.new_buffer(k_max)
    pack_prefix(buf, start, len(inputs), has_load, load_slot)
    for i, x in enumerate(inputs):
        pack_row(spec, buf, i, x, np.zeros(2, np.int8))
    repeat_last_row(buf, len(inputs), k_max)
    return torch.from_numpy(buf)


def _storages(tree) -> set:
    return {t.untyped_storage().data_ptr() for t in tree_flatten(tree)}


def test_program_writeback_load_and_aliasing():
    app = particles.make_app(rate=3, ttl=5, capacity=64, device="cpu")
    k_max, slots = 4, 6
    fn = make_megastep_fn(app.reg, app.step, app.packed_spec, app.fps, seed=app.seed,
                          retention=app.retention, k_max=k_max, ring_slots=slots)
    world = app.init_state()
    ring, tags = init_device_ring(world, slots)
    assert tags.shape == (slots + 1,)
    rng = np.random.default_rng(4)
    ins = rng.integers(0, 8, (3, 2)).astype(np.uint8)
    # 3 real rows of 4 from frame I32_MAX - 1: frames wrap, row 3 is padding
    start = I32_MAX - 1
    final, ring, tags, stacked, checks = fn(world, ring, tags, _packed(app, k_max, start, ins))
    frames = [frame_add(start, i + 1) for i in range(3)]
    assert tags.tolist()[:slots] == [
        next((f for f in frames if f % slots == s), -1) for s in range(slots)]
    ref_final, ref_stacked, ref_checks = resim_padded(
        app.reg, app.step, world, np.concatenate([ins, ins[-1:]]), np.zeros((4, 2), np.int8),
        start, 3, app.retention, app.fps)
    assert torch.equal(checks, ref_checks)
    for a, b in zip(tree_flatten(final), tree_flatten(ref_final)):
        assert torch.equal(a, b)
    for i, f in enumerate(frames):
        for r, s in zip(tree_flatten(ring), tree_flatten(stacked)):
            assert torch.equal(r[f % slots], s[i])
    # nothing returned shares storage with the ring
    assert not (_storages(ring) & (_storages(final) | _storages(stacked)))
    kept_final = [t.clone() for t in tree_flatten(final)]
    kept_stacked = [t.clone() for t in tree_flatten(stacked)]
    # a fused load of the first written frame, then a call that overwrites
    # that frame's slot: the first call's outputs stay as they were
    target = frames[0]
    ins2 = rng.integers(0, 8, (2, 2)).astype(np.uint8)
    out2 = fn(final, ring, tags, _packed(app, k_max, target, ins2, 1, target % slots))
    host = resim_padded(app.reg, app.step, slice_of(stacked, 0),
                        np.concatenate([ins2, ins2[-1:], ins2[-1:]]),
                        np.zeros((4, 2), np.int8), target, 2, app.retention, app.fps)
    assert torch.equal(out2[4], host[2])  # the fused load restored frame `target`
    overwrite = frame_add(target, 1)  # the next frame in the target's slot
    while overwrite % slots != target % slots:
        overwrite = frame_add(overwrite, 1)
    ins3 = rng.integers(0, 8, (1, 2)).astype(np.uint8)
    fn(out2[0], ring, tags, _packed(app, k_max, frame_add(overwrite, -1), ins3))
    assert tags[target % slots].item() == overwrite
    for a, b in zip(tree_flatten(final), kept_final):
        assert torch.equal(a, b)
    for a, b in zip(tree_flatten(stacked), kept_stacked):
        assert torch.equal(a, b)


def slice_of(stacked, i):
    from bevy_ggrs_tpu_torch.ops.resim import slice_frame

    return slice_frame(stacked, i)


# -- against the JAX runner (pipeline=False) --------------------------------------------


def test_megastep_synctest_equals_the_jax_runner():
    def jdrive(megastep):
        app = j_fixed_point.make_app()
        session = J.SyncTestSession(num_players=2, input_shape=(), input_dtype=np.uint8,
                                    check_distance=3, compare_interval=1)
        t = [0]

        def read_inputs(handles):
            t[0] += 1
            return {h: np.uint8((t[0] * 7 + h * 3) & 0xF) for h in handles}

        r = J.GgrsRunner(app, session, read_inputs=read_inputs, megastep=megastep,
                         pipeline=False)
        stream = []
        for _ in range(36):
            r.update(DT)
            stream.append(r.checksum)
        r.finish()
        return r, stream

    port = _drive(megastep=True)
    jr, jstream = jdrive(True)
    assert port.frame == jr.frame and port.checksum == jr.checksum
    assert jr.stats()["fused_ring_loads"] > 0 and port.fused_ring_loads > 0
    from bevy_ggrs_tpu.snapshot.checksum import checksum_to_int

    shared = sorted(set(port.ring.frames()) & set(jr.ring.frames()))
    assert shared
    for f in shared:
        assert cs(port.ring.peek(f)) == checksum_to_int(jr.ring.peek(f)[1])
