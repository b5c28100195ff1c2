"""Checkpoints (``snapshot/persist.py``) and input replay
(``session/replay.py``) on the port, and their interchange with the JAX
package.

- Mirrors of ``tests/test_replay_persist.py`` (9): a recorded SyncTest game
  replays to its checksums, a checkpoint round-trips, a replay resumes from
  a mid-game checkpoint, a P2P recording over loopback UDP is gapless and
  replays, and the schema checks (registry drift named leaf by leaf, the
  digest and extras, dtype drift loud unless ``allow_cast``, a v1 file's
  per-leaf dtype check).
- Across the packages, bit for bit: the same registry gives the same
  schema rows and digest (particles' rows pinned); a JAX checkpoint loads
  in the port and a port checkpoint in the JAX package, leaf for leaf; a
  bfloat16 leaf is read from the raw words the JAX package writes; a JAX
  recording of a ``fixed_point`` game replays in the port to the JAX
  replay's checksums, and a port recording in the JAX package."""

import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bevy_ggrs_tpu as J
from bevy_ggrs_tpu.models import fixed_point as j_fixed_point
from bevy_ggrs_tpu.models import particles as j_particles
from bevy_ggrs_tpu.session.replay import InputRecorder as JRecorder
from bevy_ggrs_tpu.session.replay import ReplaySession as JReplay
from bevy_ggrs_tpu.snapshot import persist as jper
from bevy_ggrs_tpu.snapshot.checksum import checksum_to_int as j_checksum_to_int
from bevy_ggrs_tpu_torch import (
    App,
    GgrsRunner,
    PlayerType,
    SessionBuilder,
    SessionState,
    SyncTestSession,
    UdpNonBlockingSocket,
)
from bevy_ggrs_tpu_torch.models import box_game, fixed_point, particles
from bevy_ggrs_tpu_torch.session.replay import InputRecorder, ReplaySession
from bevy_ggrs_tpu_torch.snapshot import checksum_to_int, persist
from bevy_ggrs_tpu_torch.snapshot.persist import (
    load_checkpoint,
    load_world,
    registry_schema,
    save_world,
    schema_digest,
)
from bevy_ggrs_tpu_torch.utils.tree import tree_leaves

# particles(rate=4, ttl=8, capacity=64)'s schema digest, equal in both packages
PARTICLES_DIGEST = "b19e011a4cbeb075281f8eed5409044ab51159dffabd3d8853a6b2fc83c0d6f3"
# particles(rate=8000)'s (capacity 1,024,064): chip_smoke.py checks it on the card
PARTICLES_BIG_DIGEST = "e8a7d06a008d4b36a5f3810145315adf63cc9ce8e737820f994c9d829fc6ace3"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def cs_int(runner) -> int:
    return runner._world_checksum()


def record_run(ticks=25):
    app = box_game.make_app(num_players=2, device="cpu")
    rec = InputRecorder.for_app(app)
    rng = np.random.default_rng(5)
    session = SyncTestSession(num_players=2, input_shape=(), input_dtype=np.uint8,
                              check_distance=2)
    runner = GgrsRunner(
        app, session,
        read_inputs=lambda hs: {h: np.uint8(rng.integers(0, 16)) for h in hs},
        on_advance=rec.on_advance,
    )
    for _ in range(ticks):
        runner.tick()
    return app, rec, runner


def replay(rec):
    runner = GgrsRunner(box_game.make_app(num_players=2, device="cpu"), ReplaySession(rec))
    while not runner.session.finished:
        runner.tick()
    return runner


# -- tests/test_replay_persist.py ------------------------------------------------


def test_replay_reproduces_checksum(tmp_path):
    app, rec, live = record_run()
    assert len(rec) >= 20
    path = str(tmp_path / "match.npz")
    rec.save(path)
    replayer = replay(InputRecorder.load(path))
    entry = live.ring.peek(replayer.frame)
    if entry is not None:
        assert entry[1]() == cs_int(replayer)
    else:
        assert cs_int(replay(InputRecorder.load(path))) == cs_int(replayer)


def test_world_checkpoint_roundtrip(tmp_path):
    app, rec, runner = record_run(ticks=10)
    path = str(tmp_path / "ckpt.npz")
    save_world(path, app.reg, runner.world, frame=runner.frame)
    restored, frame = load_world(path, app.reg, device="cpu")
    assert frame == runner.frame
    assert checksum_to_int(app.checksum_fn(restored)) == checksum_to_int(
        app.checksum_fn(runner.world))


def test_replay_resumes_from_checkpoint(tmp_path):
    app, rec, _ = record_run(ticks=30)
    full = replay(rec)
    half = GgrsRunner(box_game.make_app(num_players=2, device="cpu"), ReplaySession(rec))
    for _ in range(12):
        half.tick()
    path = str(tmp_path / "mid.npz")
    save_world(path, half.app.reg, half.world, frame=half.frame)
    resumed_app = box_game.make_app(num_players=2, device="cpu")
    world, frame = load_world(path, resumed_app.reg, device="cpu")
    resumed = GgrsRunner(resumed_app, ReplaySession(rec, start_frame=frame),
                         initial_state=world)
    resumed.frame = frame
    while not resumed.session.finished:
        resumed.tick()
    assert resumed.frame == full.frame
    assert cs_int(resumed) == cs_int(full)


def test_p2p_recording_has_no_gaps_and_replays(tmp_path):
    socks = [UdpNonBlockingSocket(0, host="127.0.0.1") for _ in range(2)]
    addrs = [("127.0.0.1", s.local_addr[1]) for s in socks]
    rngs = [np.random.default_rng(7), np.random.default_rng(11)]
    runners, recs = [], []
    for i in range(2):
        app = box_game.make_app(num_players=2, device="cpu")
        rec = InputRecorder.for_app(app)
        session = (SessionBuilder.for_app(app).with_input_delay(1)
                   .add_player(PlayerType.LOCAL, i)
                   .add_player(PlayerType.REMOTE, 1 - i, addrs[1 - i])
                   .start_p2p_session(socks[i]))
        runners.append(GgrsRunner(
            app, session,
            read_inputs=lambda hs, i=i: {h: np.uint8(rngs[i].integers(0, 16)) for h in hs},
            on_advance=rec.on_advance, on_confirmed=rec.on_confirmed))
        recs.append(rec)
    for _ in range(200):
        for r in runners:
            r.update(0.0)
        if all(r.session.current_state() == SessionState.RUNNING for r in runners):
            break
        time.sleep(0.001)
    for _ in range(60):
        for r in runners:
            r.update(1.0 / 60.0)
    final = recs[0].final_frames()
    assert len(final) >= 30
    keys = sorted(final)
    assert keys == list(range(keys[0], keys[-1] + 1))
    path = str(tmp_path / "p2p.npz")
    recs[0].save(path)
    replayer = GgrsRunner(box_game.make_app(num_players=2, device="cpu"),
                          ReplaySession(InputRecorder.load(path)))
    guard = 0
    while not replayer.session.finished:
        replayer.tick()
        guard += 1
        assert guard < 10 * len(final), "replay failed to finish (gap?)"
    entry = runners[0].ring.peek(replayer.frame)
    if entry is not None:
        assert entry[1]() == cs_int(replayer)
    for s in socks:
        s.close()


def test_checkpoint_rejects_registry_mismatch(tmp_path):
    app, _, runner = record_run(ticks=3)
    path = str(tmp_path / "ckpt.npz")
    save_world(path, app.reg, runner.world)
    other = box_game.make_app(num_players=2, device="cpu")
    other.rollback_component("extra", (), torch.int32)
    with pytest.raises(ValueError):
        load_world(path, other.reg, device="cpu")


def test_checkpoint_records_schema_digest_and_extras(tmp_path):
    app, _, runner = record_run(ticks=5)
    path = str(tmp_path / "ckpt.npz")
    tail = np.arange(6, dtype=np.int64)
    save_world(path, app.reg, runner.world, frame=runner.frame, extras={"tail_frames": tail})
    z = np.load(path, allow_pickle=False)
    assert str(z["__schema_digest__"]) == schema_digest(app.reg)
    rows = registry_schema(app.reg)
    assert rows and all(r.count(":") >= 2 for r in rows)
    ck = load_checkpoint(path, app.reg, device="cpu")
    assert ck.frame == runner.frame
    np.testing.assert_array_equal(ck.extras["tail_frames"], tail)
    assert checksum_to_int(app.checksum_fn(ck.world)) == checksum_to_int(
        app.checksum_fn(runner.world))
    with pytest.raises(ValueError, match="identifier"):
        save_world(str(tmp_path / "bad.npz"), app.reg, runner.world, extras={"a b": tail})


def test_checkpoint_schema_error_names_drifted_leaves(tmp_path):
    app, _, runner = record_run(ticks=3)
    path = str(tmp_path / "ckpt.npz")
    save_world(path, app.reg, runner.world)
    other = box_game.make_app(num_players=2, device="cpu")
    other.rollback_component("shield_timer", (), torch.int32)
    with pytest.raises(ValueError, match="shield_timer"):
        load_world(path, other.reg, device="cpu")


def _val_app(dtype):
    a = App(num_players=1, capacity=4, input_shape=(), input_dtype=np.uint8, device="cpu")
    a.rollback_component("val", (), dtype, checksum=True)
    a.set_step(lambda w, ctx: w)
    return a


def test_checkpoint_dtype_mismatch_loud_unless_allow_cast(tmp_path):
    a32 = _val_app(torch.int32)
    path = str(tmp_path / "d.npz")
    save_world(path, a32.reg, a32.init_state(), frame=7)
    a16 = _val_app(torch.int16)
    with pytest.raises(ValueError, match="val"):
        load_world(path, a16.reg, device="cpu")
    world, frame = load_world(path, a16.reg, allow_cast=True, device="cpu")
    assert frame == 7
    assert world.comps["val"].dtype == torch.int16


def test_v1_checkpoint_dtype_mismatch_is_loud_per_leaf(tmp_path):
    app, _, runner = record_run(ticks=3)
    leaves = tree_leaves(runner.world)
    path = str(tmp_path / "v1.npz")
    payload = {f"leaf_{i}": x.numpy().astype(np.float64) if x.dtype == torch.float32
               else x.numpy() for i, x in enumerate(leaves)}
    np.savez_compressed(path, __version__=1, __frame__=3, __n_leaves__=len(leaves), **payload)
    with pytest.raises(ValueError, match="dtype"):
        load_world(path, app.reg, device="cpu")
    world, frame = load_world(path, app.reg, allow_cast=True, device="cpu")
    assert frame == 3
    assert checksum_to_int(app.checksum_fn(world)) == checksum_to_int(
        app.checksum_fn(runner.world))


# -- across the packages ---------------------------------------------------------------


def test_schema_rows_and_digest_equal_the_jax_package():
    kw = dict(rate=4, ttl=8, capacity=64)
    japp, tapp = j_particles.make_app(**kw), particles.make_app(device="cpu", **kw)
    assert registry_schema(tapp.reg) == jper.registry_schema(japp.reg)
    assert schema_digest(tapp.reg) == jper.schema_digest(japp.reg) == PARTICLES_DIGEST
    big = particles.make_app(rate=8000, device="cpu")
    assert big.reg.capacity == 1_024_064
    assert schema_digest(big.reg) == jper.schema_digest(
        j_particles.make_app(rate=8000).reg) == PARTICLES_BIG_DIGEST
    rows = registry_schema(tapp.reg)
    assert rows[0] == ".comps['pos']:float32:(64, 3)"
    assert ".res['rng_counter']:uint32:()" in rows and rows[-1] == ".overflow:bool:()"
    # a tree resource: sorted keys, sequence indices
    ja = J.App(num_players=1, capacity=4)
    ta = App(num_players=1, capacity=4, device="cpu")
    tree = {"b": np.zeros(2, np.float32), "a": (np.int32(1), np.int32(2))}
    ja.rollback_resource("tree", tree)
    ta.rollback_resource("tree", tree)
    assert registry_schema(ta.reg) == jper.registry_schema(ja.reg)


def _leaves_equal(jworld, tworld):
    for a, b in zip(jax.tree.leaves(jworld), tree_leaves(tworld), strict=True):
        a = np.asarray(a)
        assert a.dtype.name == str(b.dtype).removeprefix("torch.")
        assert np.array_equal(a, b.numpy())


def test_checkpoints_interchange_bit_for_bit(tmp_path):
    kw = dict(rate=4, ttl=8, capacity=64)
    japp, tapp = j_particles.make_app(**kw), particles.make_app(device="cpu", **kw)
    inputs = np.random.default_rng(2).integers(0, 16, (12, 2)).astype(np.uint8)
    status = np.zeros((12, 2), np.int8)
    jf, _, _ = japp.resim_fn(japp.init_state(), inputs, status, 0)
    jpath = str(tmp_path / "jax.npz")
    jper.save_world(jpath, japp.reg, jf, frame=12, extras={"tail": np.arange(3)})
    ck = load_checkpoint(jpath, tapp.reg, device="cpu")
    assert ck.frame == 12 and np.array_equal(ck.extras["tail"], np.arange(3))
    _leaves_equal(jf, ck.world)
    assert int(ck.world.res["rng_counter"]) == 12
    want = int(np.asarray(japp.checksum_fn(jf)).astype(np.uint64) @ np.array(
        [1 << 32, 1], np.uint64))
    assert checksum_to_int(tapp.checksum_fn(ck.world)) == want
    # the port's checkpoint loads in the JAX package, leaf for leaf
    tf, _, _ = tapp.resim_fn(ck.world, inputs[:3], status[:3], 12)
    tpath = str(tmp_path / "port.npz")
    save_world(tpath, tapp.reg, tf, frame=15)
    jw, frame = jper.load_world(tpath, japp.reg)
    assert frame == 15
    _leaves_equal(jw, tf)


def test_bfloat16_leaf_from_the_jax_words(tmp_path):
    """The JAX package's ``np.savez_compressed`` writes a bfloat16 leaf as
    raw ``|V2`` words; the port reads them back to the same bits and
    writes the same form (which the JAX package's own load refuses, as it
    refuses its own file)."""
    ja = J.App(num_players=1, capacity=4)
    ja.rollback_component("x", (2,), jnp.bfloat16)
    ta = App(num_players=1, capacity=4, device="cpu")
    ta.rollback_component("x", (2,), torch.bfloat16)
    assert registry_schema(ta.reg) == jper.registry_schema(ja.reg)
    vals = jnp.asarray(np.random.default_rng(0).standard_normal((4, 2)), jnp.bfloat16)
    jw = dataclasses.replace(ja.init_state(), comps={"x": vals})
    jpath = str(tmp_path / "jbf16.npz")
    jper.save_world(jpath, ja.reg, jw)
    assert np.load(jpath)["leaf_0"].dtype == np.dtype("V2")
    tw, _ = load_world(jpath, ta.reg, device="cpu")
    assert tw.comps["x"].dtype == torch.bfloat16
    assert np.array_equal(tw.comps["x"].view(torch.int16).numpy().view(np.uint16),
                          np.asarray(vals).view(np.uint16))
    tpath = str(tmp_path / "tbf16.npz")
    save_world(tpath, ta.reg, tw)
    assert np.array_equal(np.load(tpath)["leaf_0"], np.load(jpath)["leaf_0"])
    back, _ = load_world(tpath, ta.reg, device="cpu")
    assert torch.equal(back.comps["x"].view(torch.int16), tw.comps["x"].view(torch.int16))
    for path in (jpath, tpath):
        with pytest.raises(ValueError, match="void16"):
            jper.load_world(path, ja.reg)


def _fixed_point_game(pkg, ticks=40):
    """A recorded fixed_point SyncTest game (flipping inputs)."""
    if pkg == "jax":
        app = j_fixed_point.make_app()
        rec = JRecorder.for_app(app)
        session = J.SyncTestSession(num_players=2, input_shape=(), input_dtype=np.uint8,
                                    check_distance=2)
        kw = {"pipeline": False}
        runner_cls = J.GgrsRunner
    else:
        app = fixed_point.make_app(device="cpu")
        rec = InputRecorder.for_app(app)
        session = SyncTestSession(num_players=2, input_shape=(), input_dtype=np.uint8,
                                  check_distance=2)
        kw = {}
        runner_cls = GgrsRunner
    t = [0]

    def read_inputs(hs):
        t[0] += 1
        return {h: np.uint8(((t[0] // 3) * 5 + h) & 0xF) for h in hs}

    runner = runner_cls(app, session, read_inputs=read_inputs, on_advance=rec.on_advance, **kw)
    for _ in range(ticks):
        runner.tick()
    return rec


def _replay_stream(pkg, rec):
    if pkg == "jax":
        runner = J.GgrsRunner(j_fixed_point.make_app(), JReplay(rec), pipeline=False)
        read = lambda: j_checksum_to_int(runner._world_checksum)  # noqa: E731
    else:
        runner = GgrsRunner(fixed_point.make_app(device="cpu"), ReplaySession(rec))
        read = lambda: runner._world_checksum()  # noqa: E731
    stream = []
    while not runner.session.finished:
        runner.tick()
        stream.append((runner.frame, read()))
    return stream


@pytest.mark.parametrize("recorded_by", ["jax", "torch"])
def test_recordings_replay_across_the_packages(tmp_path, recorded_by):
    rec = _fixed_point_game(recorded_by)
    path = str(tmp_path / "rec.npz")
    rec.save(path)
    jstream = _replay_stream("jax", JRecorder.load(path))
    tstream = _replay_stream("torch", InputRecorder.load(path))
    assert len(tstream) >= 35 and tstream == jstream
    # both packages' recorders write the same arrays for the same game
    other = _fixed_point_game("torch" if recorded_by == "jax" else "jax")
    other_path = str(tmp_path / "other.npz")
    other.save(other_path)
    a, b = np.load(path), np.load(other_path)
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        assert np.array_equal(a[k], b[k]), k


def test_entry_points_need_a_card_unless_told(tmp_path, monkeypatch):
    app = particles.make_app(rate=2, ttl=3, device="cpu")
    path = str(tmp_path / "c.npz")
    save_world(path, app.reg, app.init_state())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_world(path, app.reg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        particles.make_app(rate=2, ttl=3)
    assert persist.load_checkpoint(path, app.reg, device="cpu").frame == 0
