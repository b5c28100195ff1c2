"""The port's lobby-sharded many-worlds executor and runner, held against
its unsharded path and against the JAX package.

Mirrors ``tests/test_sharded_wave.py`` (lines 62-218).  The JAX tests run
on eight virtual CPU devices; the port's counterpart is a lobby mesh of
eight logical shards of the CPU (``make_lobby_mesh(devices=[cpu] * 8)``):
each shard is its own block of lanes and its own program call, as on
eight cards.  The oracle is the unsharded executor: the sharded wave must
be bit-equal to ``BucketedWaveExecutor``'s on identical waves (finals,
stacks, checksums), and ``BatchedRunner(mesh=...)`` must reproduce the
unsharded runner's checksums tick for tick with equal dispatch counts.
``fixed_point`` lanes are held against JAX's ``ShardedWaveExecutor`` bit
for bit; float states against JAX within ``atol=1e-4`` (XLA's FMAs),
checksums wherever the bits are identical.

The two ``multichip_bench`` tests (``:221-251``) belong to the benchmark
and are not mirrored.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from bevy_ggrs_tpu.batch_runner import ShardPlanner as JShardPlanner
from bevy_ggrs_tpu.models import fixed_point as j_fixed_point
from bevy_ggrs_tpu.ops.batch import ShardedWaveExecutor as JShardedWaveExecutor
from bevy_ggrs_tpu.ops.batch import stack_worlds as j_stack_worlds
from bevy_ggrs_tpu.parallel import make_lobby_mesh as j_make_lobby_mesh
import bevy_ggrs_tpu_torch.snapshot.checksum as TC
from bevy_ggrs_tpu_torch import BatchedRunner, SyncTestSession, telemetry
from bevy_ggrs_tpu_torch.batch_runner import ShardPlanner
from bevy_ggrs_tpu_torch.convert import world_to_numpy
from bevy_ggrs_tpu_torch.models import fixed_point, stress
from bevy_ggrs_tpu_torch.ops.batch import (
    BucketedWaveExecutor,
    ShardedWaveExecutor,
    stack_worlds,
)
from bevy_ggrs_tpu_torch.ops.checksum_fold import checksum_fold as fold
from bevy_ggrs_tpu_torch.ops.packing import pack_prefix, pack_row, repeat_last_row
from bevy_ggrs_tpu_torch.parallel import lobby_sharding, make_lobby_mesh, shard_lobby_worlds
from bevy_ggrs_tpu_torch.session.events import InputStatus
from bevy_ggrs_tpu_torch.snapshot.lazy import (
    BatchChecks,
    LazySlice,
    LobbyShards,
    RowIndexStager,
    fused_load_rows,
    plan_row_gather,
    tree_index,
)
from bevy_ggrs_tpu_torch.utils.tree import tree_flatten

D = 8
FLOAT_ATOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def cpu_mesh(n: int = D):
    return make_lobby_mesh(devices=[torch.device("cpu")] * n)


def _wave(app, m, k_max, seed=0):
    """A deterministic ``[m, k_max]`` wave: worlds, inputs, status."""
    rng = np.random.default_rng(seed)
    worlds = stack_worlds([app.init_state() for _ in range(m)])
    inputs = rng.integers(0, 16, (m, k_max, app.num_players)).astype(np.uint8)
    status = np.full((m, k_max, app.num_players), InputStatus.CONFIRMED, np.int8)
    return worlds, inputs, status


def _packed(app, inputs, status, starts, ks, k_max):
    spec = app.packed_spec
    buf = spec.new_batch_buffer(len(ks), k_max)
    for b, k in enumerate(ks):
        pack_prefix(buf[b], int(starts[b]), k)
        for i in range(k):
            pack_row(spec, buf[b], i, inputs[b, i], status[b, i])
        repeat_last_row(buf[b], k, k_max)
    return buf


def _tree_equal(a, b) -> bool:
    la, lb = tree_flatten(a), tree_flatten(b)
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


def _flat(checks: LobbyShards) -> torch.Tensor:
    return checks.gather().reshape(-1, 2)


STRESS = lambda: stress.make_app(64, capacity=64, device="cpu")  # noqa: E731
FIXED = lambda: fixed_point.make_app(device="cpu")  # noqa: E731

CASES = [
    (8, [8] * 8),            # exact wave, M == D
    (16, [8] * 16),          # exact wave, M == 2D
    (12, [3, 8, 1, 5, 8, 2, 7, 4, 8, 1, 6, 8]),  # ragged, M not divisible by D
    (13, [5] * 13),          # non-power-of-two M, M not divisible by D
    (6, [2, 7, 1, 4, 8, 3]),  # ragged, M < D
]
CASE_IDS = ["exact-m8", "exact-m16", "ragged-m12", "uniform-m13", "ragged-m6"]


# -- executor-level bit equality ---------------------------------------------------


@pytest.mark.parametrize("m,ks", CASES, ids=CASE_IDS)
@pytest.mark.parametrize("app_factory", [STRESS, FIXED], ids=["stress", "fixed_point"])
def test_sharded_wave_bit_equality(app_factory, m, ks, monkeypatch):
    """Sharded against unsharded on the identical wave, unpacked and packed:
    the same bucket, bit-equal finals, stacks and checksum rows, and one
    fold launch per shard the wave's lanes fill."""
    k_max = 8
    app = app_factory()
    ref = BucketedWaveExecutor(app, k_max)
    sh = ShardedWaveExecutor(app, k_max, cpu_mesh())
    worlds, inputs, status = _wave(app, m, k_max)
    starts = np.arange(m, dtype=np.int32) * 3

    rb, rf, rs, rc = ref.run_wave(worlds, inputs, status, starts, ks)
    sb, sf, ss, sc = sh.run_wave(worlds, inputs, status, starts, ks)
    assert sb == rb
    assert isinstance(sf, LobbyShards) and len(sf) == m
    assert _tree_equal(sf.gather(), rf), "finals diverged"
    assert _tree_equal(ss.gather(), rs), "stacked snapshots diverged"
    assert torch.equal(_flat(sc), rc), "checksums diverged"
    assert BatchChecks(sc).host() == rc.tolist()

    buf = _packed(app, inputs, status, starts, ks, k_max)
    rb, rf, rs, rc = ref.run_wave_packed(worlds, buf, ks)
    folds = []
    monkeypatch.setattr(TC, "checksum_fold", lambda *a: folds.append(1) or fold(*a))
    sb, sf, ss, sc = sh.run_wave_packed(worlds, buf, ks)
    assert len(folds) == D  # one fold pass per shard, pad shards too
    assert sb == rb
    assert _tree_equal(sf.gather(), rf)
    assert _tree_equal(ss.gather(), rs)
    assert torch.equal(_flat(sc), rc)


def test_sharded_wave_mixed_depth_sequence():
    """Consecutive waves of different bucket depths (program-cache reuse
    across waves) stay bit-equal, finals threaded wave to wave."""
    app = STRESS()
    ref = BucketedWaveExecutor(app, 8)
    sh = ShardedWaveExecutor(app, 8, cpu_mesh())
    m = 12
    worlds, inputs, status = _wave(app, m, 8)
    rw = sw = worlds
    for tick, ks in enumerate([[1] * m, [4, 2, 1, 4, 3, 4, 1, 2, 4, 4, 1, 3],
                               [8] * m, [1] * m]):
        starts = np.full((m,), tick * 8, np.int32)
        _, rw, _, rc = ref.run_wave(rw, inputs, status, starts, ks)
        plain = sw.gather() if isinstance(sw, LobbyShards) else sw
        _, sw, _, sc = sh.run_wave(plain, inputs, status, starts, ks)
        assert torch.equal(_flat(sc), rc), f"tick {tick}"
    assert _tree_equal(sw.gather(), rw)
    assert sh.stats()["bucket_hist"] == {1: 2, 4: 1, 8: 1}


def test_sharded_executor_bookkeeping():
    """pad_lobbies, the recycle refusal, the per-shard harvest census and
    the stats; a resident LobbyShards world of the wrong layout is refused."""
    app = STRESS()
    mesh = cpu_mesh()
    sh = ShardedWaveExecutor(app, 8, mesh)
    assert [sh.pad_lobbies(m) for m in (1, 7, 8, 9, 16, 17)] == [8, 8, 8, 16, 16, 24]
    with pytest.raises(ValueError, match="recycle_outputs"):
        ShardedWaveExecutor(app, 8, mesh, recycle_outputs=True)

    worlds, inputs, status = _wave(app, 16, 8)
    _, finals, _, _ = sh.run_wave(worlds, inputs, status, np.zeros(16, np.int32), [8] * 16)
    census = sh.harvest_shards(finals)
    assert census["n_devices"] == D
    assert census["devices_touched"] == D  # eight logical shards, told apart
    assert sorted(census["buffers_per_device"]) == sorted(mesh.shard_names())
    assert all(v > 0 for v in census["buffers_per_device"].values())
    assert sh.stats()["shard_devices"] == D
    assert sh.stats()["host_uploads"] == 3
    with pytest.raises(ValueError, match="resident shards"):
        sh.run_wave(LobbyShards(finals.parts[:4], 4), inputs, status,
                    np.zeros(16, np.int32), [8] * 16)


def test_lobby_mesh_layout_and_shard_aware_slices():
    """Lobby b lives on shard b // lanes at row b % lanes: ``lobby_sharding``,
    ``shard_lobby_worlds``, ``tree_index``, ``LazySlice``, ``BatchChecks``
    and a fused load into a LobbyShards world all agree with the plain
    ``[M, ...]`` layout."""
    app = FIXED()
    mesh = cpu_mesh(4)
    assert mesh.size == 4 and mesh.axis_names == ("lobby",)
    assert mesh.shard_names() == ["cpu#0", "cpu#1", "cpu#2", "cpu#3"]
    sharding = lobby_sharding(mesh)
    assert [sharding.shard_of(b, 8) for b in range(8)] == [0, 0, 1, 1, 2, 2, 3, 3]
    with pytest.raises(ValueError, match="pad them"):
        sharding.lanes(6)
    worlds, inputs, status = _wave(app, 8, 4, seed=2)
    ref = BucketedWaveExecutor(app, 4)
    _, plain, plain_stack, plain_checks = ref.run_wave(
        worlds, inputs, status, np.zeros(8, np.int32), [4] * 8)
    shards = shard_lobby_worlds(mesh, plain)
    assert shards.lanes == 2 and len(shards) == 8
    for b in range(8):
        assert _tree_equal(tree_index(shards, b), tree_index(plain, b))
        assert shards.locate(b) == (b // 2, b % 2)
    stacks = shard_lobby_worlds(mesh, plain_stack)
    assert _tree_equal(LazySlice(stacks, (5, 2)).materialize(),
                       LazySlice(plain_stack, (5, 2)).materialize())
    checks = shard_lobby_worlds(mesh, plain_checks.view(8, 4, 2))
    assert BatchChecks(checks).host() == plain_checks.tolist()
    # a mixed-source load: lobby 5 from its own shard's stack, lobby 2
    # from a resident row; same rows as the plain load
    handles = [(5, LazySlice(stacks, (5, 1))), (2, LazySlice(shards, 2))]
    plain_handles = [(5, LazySlice(plain_stack, (5, 1))), (2, LazySlice(plain, 2))]
    stager = RowIndexStager("cpu")
    groups, fallback = plan_row_gather(handles)
    assert not fallback and len(groups) == 2
    loaded = fused_load_rows(shards, groups, stager)
    want = fused_load_rows(plain, plan_row_gather(plain_handles)[0], stager)
    assert _tree_equal(loaded.gather(), want)


# -- telemetry -----------------------------------------------------------------------


def test_sharded_telemetry_counters():
    """The pre-bound sharded counters and the shard_imbalance_ratio gauge."""
    telemetry.disable()
    telemetry.reset()
    telemetry.enable()
    try:
        app = STRESS()
        sh = ShardedWaveExecutor(app, 8, cpu_mesh())
        worlds, inputs, status = _wave(app, 8, 8)
        sh.run_wave(worlds, inputs, status, np.zeros(8, np.int32), [8] * 8)
        sh.run_wave(worlds, inputs, status, np.zeros(8, np.int32), [4, 8, 1, 2, 8, 3, 5, 6])
        reg = telemetry.registry()
        assert reg.counter("sharded_wave_dispatches_total").value() == 2
        assert reg.counter("shard_program_compiles_total").value() == 2  # exact + padded

        planner = ShardPlanner(12, 4)
        plan = planner.plan([8, 8, 8, 0, 0, 0, 0, 0, 0, 0, 0, 0])
        assert plan["imbalance_ratio"] == pytest.approx(4.0)
        assert reg.gauge("shard_imbalance_ratio").value() == pytest.approx(4.0)
        assert planner.plan([1] * 12)["imbalance_ratio"] == pytest.approx(1.0)
        assert planner.max_imbalance == pytest.approx(4.0)
    finally:
        telemetry.disable()
        telemetry.reset()


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_shard_planner_equals_jax(seed):
    """ShardPlanner's host arithmetic equals the JAX class's on seeded
    random waves (layout, every plan, the running imbalances)."""
    rng = np.random.default_rng(seed)
    m = int(rng.integers(1, 40))
    d = int(rng.integers(1, 9))
    mine, theirs = ShardPlanner(m, d), JShardPlanner(m, d)
    assert (mine.m_pad, mine.lanes_per_shard) == (theirs.m_pad, theirs.lanes_per_shard)
    assert [mine.shard_of(b) for b in range(m)] == [theirs.shard_of(b) for b in range(m)]
    for _ in range(6):
        ks = [int(k) if rng.random() < 0.6 else 0 for k in rng.integers(1, 9, m)]
        assert mine.plan(ks) == theirs.plan(ks)
    assert (mine.last_imbalance, mine.max_imbalance, mine.waves_planned) == \
        (theirs.last_imbalance, theirs.max_imbalance, theirs.waves_planned)


def test_fixed_point_lanes_equal_jax_sharded_executor(eight_devices):
    """fixed_point lanes against JAX's ShardedWaveExecutor on its eight
    virtual devices: states and checksums bit for bit (integer model)."""
    m, k_max = 12, 8
    ks = [3, 8, 1, 5, 8, 2, 7, 4, 8, 1, 6, 8]
    app, japp = FIXED(), j_fixed_point.make_app()
    worlds, inputs, status = _wave(app, m, k_max, seed=4)
    starts = np.arange(m, dtype=np.int32) * 5
    _, sf, ss, sc = ShardedWaveExecutor(app, k_max, cpu_mesh()).run_wave(
        worlds, inputs, status, starts, ks)
    jex = JShardedWaveExecutor(japp, k_max, j_make_lobby_mesh(len(eight_devices)))
    jworlds = j_stack_worlds([japp.init_state() for _ in range(m)])
    _, jf, js, jc = jex.run_wave(jworlds, inputs, status, starts, ks)
    assert np.array_equal(_flat(sc).numpy(), np.asarray(jc).astype(np.int64))
    got = world_to_numpy(sf.gather())
    for name, arr in got["comps"].items():
        assert np.array_equal(arr, np.asarray(jf.comps[name])), name
    for f in ("alive", "rollback_id", "next_id"):
        assert np.array_equal(got[f], np.asarray(getattr(jf, f))), f
    stack = world_to_numpy(ss.gather())
    for name, arr in stack["comps"].items():
        assert np.array_equal(arr, np.asarray(js.comps[name])), name


# -- driver level ----------------------------------------------------------------------


def _lobby_inputs(lobby, tick, handles):
    rng = np.random.default_rng(1000 * lobby + tick)
    return {h: np.uint8(rng.integers(0, 16)) for h in handles}


def _run_driver(app_factory, m, ticks, mesh, packed=True):
    app = app_factory()
    t = [0]
    sessions = [SyncTestSession(num_players=2, input_shape=(), input_dtype=np.uint8,
                                check_distance=2, compare_interval=1) for _ in range(m)]
    br = BatchedRunner(app, sessions, read_inputs=lambda lobby, hs: _lobby_inputs(
        lobby, t[0], hs), mesh=mesh, packed=packed)
    sums = [[] for _ in range(m)]
    for _ in range(ticks):
        br.tick()
        t[0] += 1
        for b in range(m):
            sums[b].append(br.lobby_checksum(b))
    br.finish()  # the SyncTest oracle raises on any restore mismatch
    return br, sums


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "unpacked"])
def test_batched_runner_sharded_matches_unsharded(packed):
    """M=6 lobbies on D=8 shards (two permanent pad lanes) with rollbacks:
    checksums and dispatch counts equal the unsharded runner's, and every
    wave went through the sharded executor."""
    m, ticks = 6, 18
    ref, ref_sums = _run_driver(STRESS, m, ticks, mesh=None, packed=packed)
    sh, sh_sums = _run_driver(STRESS, m, ticks, mesh=cpu_mesh(), packed=packed)
    assert sh_sums == ref_sums
    assert sh.device_dispatches == ref.device_dispatches
    assert sh.rollbacks == ref.rollbacks > 0
    assert isinstance(sh.exec, ShardedWaveExecutor)
    assert isinstance(sh.worlds, LobbyShards) and len(sh.worlds) == 8
    s = sh.stats()["sharded"]
    assert s["devices"] == D and s["pad_lanes"] == 2 and s["lanes_per_shard"] == 1
    assert s["waves_planned"] == sh.exec.dispatch_count > 0
    assert sh.stats()["shard_devices"] == D
    for b in range(m):
        assert _tree_equal(sh.lobby_world(b), ref.lobby_world(b))


def test_batched_runner_single_device_fallback():
    """A one-shard mesh keeps the plain executor: no planner, no pad lanes,
    no "sharded" stats."""
    app = STRESS()
    br = BatchedRunner(
        app, [SyncTestSession(num_players=2, input_shape=(), input_dtype=np.uint8,
                              check_distance=2, compare_interval=1)],
        read_inputs=lambda lobby, handles: {h: np.uint8(0) for h in handles},
        mesh=cpu_mesh(1))
    assert not isinstance(br.exec, ShardedWaveExecutor)
    assert br.planner is None and br.mesh is None
    assert "sharded" not in br.stats()
    br.tick()
    br.finish()


def test_batched_runner_refuses_speculation_with_a_mesh():
    from bevy_ggrs_tpu_torch import SpeculationConfig, pad_candidates

    app = STRESS()
    sessions = [SyncTestSession(num_players=2, input_shape=(), input_dtype=np.uint8,
                                check_distance=2) for _ in range(4)]
    with pytest.raises(ValueError, match="not shard-aware"):
        BatchedRunner(app, sessions, mesh=cpu_mesh(4), speculation=SpeculationConfig(
            candidates_fn=pad_candidates(2, [1], range(4)), depth=2))


def test_jax_layout_matches(eight_devices):
    """The JAX lobby mesh splits M_pad lanes in the same contiguous blocks
    the port's shards hold (its per-device shard of a padded world)."""
    japp = j_fixed_point.make_app()
    jworlds = j_stack_worlds([japp.init_state() for _ in range(16)])
    from bevy_ggrs_tpu.parallel import shard_lobby_worlds as j_shard

    placed = j_shard(j_make_lobby_mesh(8), jworlds)
    rows = sorted((s.index[0].start, s.index[0].stop)
                  for s in placed.alive.addressable_shards)
    mine = shard_lobby_worlds(cpu_mesh(), stack_worlds([FIXED().init_state()] * 16))
    assert rows == [(d * mine.lanes, (d + 1) * mine.lanes) for d in range(D)]
    assert jax.device_count() == D
    assert dataclasses.is_dataclass(mine.parts[0])
