"""Card-only tests of the PyTorch port: the checksum pass kernel against its
plain version on every lane dtype, ragged and unaligned stacks, many
components and frame counts; the pass with no host sync and inside a CUDA
graph; the entry points' CUDA default; a checksum ref's non-blocking read;
a P2P pair on the card launching the fold once per resim; the pipelined,
packed, donating tick with no host sync; a pinned staging buffer never
rewritten before its upload's event; the fold on a packed resim's stack;
and speculation's branch axis: speculate lanes and canonical-branched
lanes bit for bit against the plain and canonical resims on the card, the
fold on a branch stack, and a hedged P2P pair with no host sync and no
desync; many worlds: a packed wave's lanes bit for bit against solo
resims, the fold on a wave stack, and the batched runner's launches per
tick flat in the lobby count; telemetry: a pair with telemetry on under
sync debug "error", reconciling its phases, blame and devmem rows, the
strict device-memory census against the allocator, and a forensics report
on a forced desync, its per-component parts from the fold kernel equal to
the CPU's.

Marked ``cuda``; each skips without a card.  This file imports neither JAX
nor the JAX package, so it runs on a machine without JAX:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import time

import numpy as np
import pytest
import torch

from bevy_ggrs_tpu_torch import (
    App,
    DesyncDetection,
    GgrsRunner,
    PlayerType,
    SessionBuilder,
    SpeculationConfig,
    pad_candidates,
    select_branch,
)
from bevy_ggrs_tpu_torch.models import box_game, fixed_point, stress_soa
from bevy_ggrs_tpu_torch.ops import resim as tr
from bevy_ggrs_tpu_torch.ops import checksum_fold as cf
from bevy_ggrs_tpu_torch.ops.packing import PackedUpload, pack_prefix, pack_row, prefix_words
from bevy_ggrs_tpu_torch.session.channel import ChannelNetwork
from bevy_ggrs_tpu_torch.session.events import DesyncDetected
from bevy_ggrs_tpu_torch.snapshot.lazy import BatchChecks, ReadbackStats, tree_index
from bevy_ggrs_tpu_torch.utils import staging
from bevy_ggrs_tpu_torch.utils.staging import StagingBuffer, TransferRaceError
from bevy_ggrs_tpu_torch.utils.tree import tree_flatten, tree_map
from bevy_ggrs_tpu_torch.snapshot import (
    WorldState,
    branch_checksums,
    despawn_where,
    fold_inputs,
    remove_component,
    spawn_many,
    world_checksums,
)

pytestmark = pytest.mark.cuda

N = 5000
K = 4

DTYPES = {
    "float32": (torch.float32, (2,)),
    "int32": (torch.int32, ()),
    "uint32": (torch.uint32, (3,)),
    "bfloat16": (torch.bfloat16, (3,)),
    "float16": (torch.float16, ()),
    "float64": (torch.float64, (2,)),
    "int64": (torch.int64, ()),
    "bool": (torch.bool, ()),
    "int8": (torch.int8, (4,)),
    "int16": (torch.int16, ()),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the fold kernel runs only on the card")
    return torch.device("cuda", 0)


def _values(rng, dtype, shape, rows=N):
    size = (rows, *shape)
    if dtype == torch.bool:
        return torch.from_numpy(rng.integers(0, 2, size).astype(bool))
    if dtype.is_floating_point:
        return torch.from_numpy(rng.standard_normal(size)).to(dtype)
    info = torch.iinfo(dtype)
    lo, hi = max(info.min, -2**62), min(info.max, 2**62)
    return torch.from_numpy(rng.integers(lo, hi, size, dtype=np.int64)).to(dtype)


def _stacked(app, dev, seed, k=K):
    """A [k, rows] stack of worlds with despawned and has-false rows."""
    rng = np.random.default_rng(seed)
    rows = app.reg.capacity
    cols = {n: _values(rng, s.dtype, s.shape, rows) for n, s in app.reg.components.items()}
    w = spawn_many(app.reg, app.init_state(), cols, rows - 50)
    w = despawn_where(app.reg, w, torch.from_numpy(rng.random(rows) < 0.1).to(dev), 0)
    for slot in rng.integers(0, rows - 50, 20):
        w = remove_component(app.reg, w, int(slot), next(iter(app.reg.components)))
    inputs = torch.zeros((k, 2), dtype=torch.uint8, device=dev)
    return app.resim_fn(w, inputs, torch.zeros((k, 2), dtype=torch.int8, device=dev), 0)[1]


def _dtype_args(name, dev):
    """checksum_fold arguments of one lane dtype beside a custom-hashed column."""
    dtype, shape = DTYPES[name]
    app = App(capacity=N, device=dev)
    app.rollback_component("c", shape, dtype, checksum=True)
    app.rollback_component("h", (), torch.int32, checksum=True,
                           hash_fn=lambda col: col * 7 + 1)
    app.set_step(lambda w, ctx: w)
    stacked = _stacked(app, dev, seed=len(name))
    return fold_inputs(app.reg, stacked, ["c", "h"], seeds=(1, 2))


def _layout_args(name, dev):
    """checksum_fold arguments of one stack shape or memory layout."""
    if name in ("ragged_n", "ragged_frame_slice"):
        app = stress_soa.make_app(n_entities=N + 3, device=dev)
        stacked = _stacked(app, dev, seed=1)
        if name == "ragged_frame_slice":
            stacked = WorldState(**{f: _frames(v, 1, 3) for f, v in vars(stacked).items()})
    elif name == "aligned_frame_slice":
        app = stress_soa.make_app(n_entities=4096, device=dev)
        stacked = _stacked(app, dev, seed=2)
        stacked = WorldState(**{f: _frames(v, 1, 3) for f, v in vars(stacked).items()})
    elif name == "20_components":
        app = App(capacity=N, device=dev)
        for i in range(20):
            app.rollback_component(f"c{i}", [(), (2,), (3,)][i % 3],
                                   torch.float32 if i % 2 else torch.int32, checksum=True)
        app.set_step(lambda w, ctx: w)
        stacked = _stacked(app, dev, seed=3)
    elif name in ("k1", "k17"):
        app = stress_soa.make_app(n_entities=N, device=dev)
        stacked = _stacked(app, dev, seed=4, k=int(name[1:]))
    else:
        assert name == "no_checksummed_component"
        app = stress_soa.make_app(n_entities=N, checksum=False, device=dev)
        stacked = _stacked(app, dev, seed=5)
    names = [n for n, s in app.reg.components.items() if s.checksum]
    return fold_inputs(app.reg, stacked, names)


def _frames(v, lo, hi):
    if isinstance(v, torch.Tensor):
        return v[lo:hi]
    return {n: _frames(t, lo, hi) for n, t in v.items()}


LAYOUTS = ["ragged_n", "ragged_frame_slice", "aligned_frame_slice", "20_components",
           "k1", "k17", "no_checksummed_component"]


@pytest.mark.parametrize("name", sorted(DTYPES) + LAYOUTS)
def test_fold_kernel_equals_plain(cuda, name):
    args = _dtype_args(name, cuda) if name in DTYPES else _layout_args(name, cuda)
    before = cf.launches
    got = cf.checksum_fold(*args)
    torch.cuda.synchronize()
    assert cf.launches == before + 1
    assert torch.equal(got, cf.checksum_fold_plain(*args))


def test_world_checksums_on_card_equal_cpu(cuda):
    app_gpu = stress_soa.make_app(n_entities=N, device=cuda)
    app_cpu = stress_soa.make_app(n_entities=N, device="cpu")
    stacked = _stacked(app_gpu, cuda, seed=5)
    on_cpu = type(stacked)(**{
        f: (v.cpu() if isinstance(v, torch.Tensor) else {n: t.cpu() for n, t in v.items()})
        for f, v in vars(stacked).items()
    })
    assert torch.equal(world_checksums(app_gpu.reg, stacked).cpu(),
                       world_checksums(app_cpu.reg, on_cpu))


def test_runner_launches_the_kernel(cuda):
    app = fixed_point.make_app(device=cuda)
    session = SessionBuilder.for_app(app).with_check_distance(4).start_synctest_session()
    runner = GgrsRunner(app, session)
    cf.launches = 0
    for _ in range(40):
        runner.tick()
    runner.finish()
    assert cf.launches > 0
    assert runner.rollbacks > 0


def test_entry_points_default_to_cuda(cuda):
    assert App().device.type == "cuda"
    assert fixed_point.make_app().init_state().device.type == "cuda"


def test_world_checksums_make_no_host_sync(cuda):
    app = stress_soa.make_app(n_entities=N, device=cuda)
    stacked = _stacked(app, cuda, seed=6)
    want = world_checksums(app.reg, stacked)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = world_checksums(app.reg, stacked)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(got, want)


def test_world_checksums_replay_in_a_cuda_graph_bit_exact(cuda):
    app = stress_soa.make_app(n_entities=N, device=cuda)
    stacked = _stacked(app, cuda, seed=7)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        world_checksums(app.reg, stacked)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = world_checksums(app.reg, stacked)
    graph.replay()
    torch.cuda.synchronize()
    before = captured.clone()
    stacked.comps["vx"].mul_(-2.0)
    stacked.despawn_pending[:, ::5] = True
    stacked.next_id.add_(1)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, world_checksums(app.reg, stacked))
    assert not torch.equal(captured, before)


def test_checksum_ref_peek_never_syncs(cuda):
    app = stress_soa.make_app(n_entities=N, device=cuda)
    k = 4
    zeros = torch.zeros((k, 2), dtype=torch.uint8, device=cuda)
    _, _, checks = app.resim_fn(app.init_state(), zeros, zeros.to(torch.int8), 0)
    want = checks.cpu().tolist()
    torch.cuda._sleep(100_000_000)  # keep the stream busy past the first peek
    stats = ReadbackStats()
    refs = BatchChecks(checks, stats)
    torch.cuda.set_sync_debug_mode("error")
    try:
        first = refs.ref(2).peek()
        got = first
        deadline = time.monotonic() + 30.0
        while got is None and time.monotonic() < deadline:
            time.sleep(0.001)
            got = refs.ref(2).peek()
        rest = [refs.ref(i).peek() for i in range(k)]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert first is None and stats.peek_misses >= 1 and stats.forced == 0
    assert rest == [(hi << 32) | lo for hi, lo in want]
    assert got == rest[2] == BatchChecks(checks).ref(2)()


def test_p2p_pair_on_card_launches_the_fold_once_per_resim(cuda):
    net = ChannelNetwork(latency_hops=3, seed=1)
    socks = [net.endpoint("p0"), net.endpoint("p1")]
    runners = []
    for i in range(2):
        app = fixed_point.make_app(device=cuda)
        session = (SessionBuilder.for_app(app).with_input_delay(1)
                   .with_desync_detection_mode(DesyncDetection.on(1))
                   .add_player(PlayerType.LOCAL, i)
                   .add_player(PlayerType.REMOTE, 1 - i, f"p{1 - i}")
                   .start_p2p_session(socks[i]))
        holder = []

        def read_inputs(handles, i=i, holder=holder):
            on = (holder[0].frame // 7) % 2 == 0 or i == 1
            return {h: np.uint8(8 if on else 1) for h in handles}

        runners.append(GgrsRunner(app, session, read_inputs=read_inputs))
        holder.append(runners[-1])
    cf.launches = 0
    for _ in range(100):
        net.deliver()
        for r in runners:
            r.update(0.0 if r.session.current_state().value != "running" else 1 / 60)
    for r in runners:
        r.finish()
    assert runners[1].rollbacks > 0 and min(r.frame for r in runners) > 50
    assert cf.launches == sum(r.resims for r in runners)
    assert not [e for r in runners for e in r.events if isinstance(e, DesyncDetected)]


def _flipping_pair(app_fn, cuda, **runner_kw):
    """Two peers over a 3-hop channel, peer 0's input flipping every 7
    frames, synchronized."""
    net = ChannelNetwork(latency_hops=3, seed=1)
    socks = [net.endpoint("p0"), net.endpoint("p1")]
    runners = []
    for i in range(2):
        app = app_fn()
        session = (SessionBuilder.for_app(app).with_input_delay(1)
                   .with_desync_detection_mode(DesyncDetection.on(1))
                   .add_player(PlayerType.LOCAL, i)
                   .add_player(PlayerType.REMOTE, 1 - i, f"p{1 - i}")
                   .start_p2p_session(socks[i]))
        holder = []

        def read_inputs(handles, i=i, holder=holder):
            on = (holder[0].frame // 7) % 2 == 0 or i == 1
            return {h: np.uint8(8 if on else 1) for h in handles}

        runners.append(GgrsRunner(app, session, read_inputs=read_inputs, **runner_kw))
        holder.append(runners[-1])
    for _ in range(500):
        net.deliver()
        for r in runners:
            r.update(0.0)
        if all(r.session.current_state().value == "running" for r in runners):
            return net, runners
    raise AssertionError("sessions never synchronized")


def test_pipelined_tick_makes_no_host_sync(cuda):
    """The runner's default path (pipelined, packed, donating) ticks under
    sync debug mode "error": no sync, no pageable copy; and no forced read
    or staging wait, which that mode cannot see."""
    net, runners = _flipping_pair(lambda: stress_soa.make_app(n_entities=N, device=cuda),
                                  cuda)
    for _ in range(30):  # warm the allocators and the readback pool
        net.deliver()
        for r in runners:
            r.update(1 / 60)
    before = [r.stats() for r in runners]
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(60):
            net.deliver()
            for r in runners:
                r.update(1 / 60)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    after = [r.stats() for r in runners]
    for r in runners:
        r.finish()
    for b, a in zip(before, after):
        assert a["readbacks"]["forced"] == b["readbacks"]["forced"]
        assert a["staging_deferred_blocks"] == b["staging_deferred_blocks"]
        resims = a["device_dispatches"] - b["device_dispatches"]
        assert a["host_uploads"] - b["host_uploads"] == resims > 0
        assert a["donated_dispatches"] > b["donated_dispatches"]
    assert after[1]["rollbacks"] > before[1]["rollbacks"]
    assert not [e for r in runners for e in r.events if isinstance(e, DesyncDetected)]


def test_staging_buffer_not_rewritten_before_its_event(cuda):
    """A commit queued behind work on the side stream has not landed: the
    next acquire waits on its event (a deferred block), so the rewrite
    cannot reach the upload; armed, the sanitizer refuses a rewrite that
    skips the acquire."""
    stage = StagingBuffer(lambda: np.zeros((4, 1 << 20), np.int8), cuda)
    buf = stage.acquire()
    buf[:] = 1
    with torch.cuda.stream(stage.stream):
        torch.cuda._sleep(200_000_000)  # hold the copy back
    dev = stage.commit(buf)
    assert not stage._event.query()
    again = stage.acquire()
    assert again is buf and stage.deferred_blocks == 1 and stage._event.query()
    again[:] = 2
    assert int(dev.to(torch.int64).sum()) == buf.size  # the upload kept the 1s
    san = staging.set_sanitize(True)
    try:
        stage.commit(buf)
        with pytest.raises(TransferRaceError, match="in flight"):
            pack_prefix(buf, 0, 3)
        stage.acquire()
        pack_prefix(buf, 0, 3)
        assert san.violations == 1
    finally:
        staging.set_sanitize(False)


def test_fold_bit_exact_on_packed_resim_stack(cuda):
    """A packed resim (one pinned upload, split on the card) gives the
    unpacked resim's checksums, and the fold on its stack is bit-exact
    against the plain version."""
    app = stress_soa.make_app(n_entities=N, device=cuda)
    spec = app.packed_spec
    stage = StagingBuffer(lambda: spec.new_buffer(K), cuda)
    rng = np.random.default_rng(9)
    inputs = rng.integers(0, 16, (K, 2)).astype(np.uint8)
    status = rng.integers(0, 3, (K, 2)).astype(np.int8)
    buf = stage.acquire()
    pack_prefix(buf, 5, K)
    for i in range(K):
        pack_row(spec, buf, i, inputs[i], status[i])
    packed = PackedUpload(stage.commit(buf), *prefix_words(buf))
    world = tree_index(_stacked(app, cuda, seed=2, k=1), 0)  # despawned, has-false rows
    _, stacked, checks = app.packed_resim_fn(world, packed)
    _, _, want = app.resim_fn(world, torch.from_numpy(inputs).to(cuda),
                              torch.from_numpy(status).to(cuda), 5)
    names = [n for n, c in app.reg.components.items() if c.checksum]
    args = fold_inputs(app.reg, stacked, names)
    got = cf.checksum_fold(*args)
    assert torch.equal(got, cf.checksum_fold_plain(*args))
    assert torch.equal(checks, want)


# -- speculation's branch axis on the card ---------------------------------------


def _trees_equal(a, b):
    return all(x.shape == y.shape and torch.equal(x, y)
               for x, y in zip(tree_flatten(a), tree_flatten(b), strict=True))


def _lane_inputs(app, lanes, depth, seed, dev):
    rng = np.random.default_rng(seed)
    ib = rng.integers(0, 16, (lanes, depth, app.num_players)).astype(np.uint8)
    sb = rng.integers(0, 2, (lanes, depth, app.num_players)).astype(np.int8)
    return torch.from_numpy(ib).to(dev), torch.from_numpy(sb).to(dev)


@pytest.mark.parametrize("model", ["box_game", "stress_soa", "fixed_point"])
def test_speculate_lanes_equal_resim_on_card(cuda, model):
    app = {"box_game": lambda: box_game.make_app(num_players=4, capacity=64, device=cuda),
           "stress_soa": lambda: stress_soa.make_app(n_entities=N, device=cuda),
           "fixed_point": lambda: fixed_point.make_app(device=cuda)}[model]()
    world = app.init_state()
    ib, sb = _lane_inputs(app, 4, K, seed=1, dev=cuda)
    tr.vmap_fallbacks = 0
    cf.launches = 0
    finals, stacked, checks = app.speculate_fn(world, ib, sb, 2)
    assert cf.launches == 1 and tr.vmap_fallbacks == 0
    for b in range(4):
        want = app.resim_fn(world, ib[b], sb[b], 2)
        assert _trees_equal(select_branch((finals, stacked, checks), b), want), b


@pytest.mark.parametrize("model", ["box_game", "stress_soa"])
def test_branched_lanes_equal_canonical_resim_on_card(cuda, model):
    lanes, depth, k = 5, 8, 3

    def make():
        if model == "box_game":
            return box_game.make_app(num_players=4, capacity=64, canonical_depth=depth,
                                     device=cuda)
        return stress_soa.make_app(n_entities=N, canonical_depth=depth, device=cuda)

    app, plain = make(), make()
    app.canonical_branches = lanes
    world = app.init_state()
    ib, sb = _lane_inputs(app, lanes, depth, seed=2, dev=cuda)
    n_real = [k] + [depth] * (lanes - 1)
    finals, stacked, checks = app.branched_fn(world, ib, sb, 6, n_real)
    lane0 = plain.resim_fn(world, ib[0, :k], sb[0, :k], 6)
    got0 = select_branch((finals, *tr.trim_frames((stacked, checks), k, axis=1)), 0)
    assert _trees_equal(got0, lane0)
    for i in range(k, depth):  # lane 0 holds its state past n_real
        assert torch.equal(checks[0, i], checks[0, k - 1])
    for b in range(1, lanes):
        assert _trees_equal(select_branch((finals, stacked, checks), b),
                            plain.resim_fn(world, ib[b], sb[b], 6)), b
    facade = app.resim_fn(world, ib[0, :k], sb[0, :k], 6)
    assert _trees_equal(facade, lane0)


def test_fold_on_branch_stack_equals_plain(cuda):
    app = stress_soa.make_app(n_entities=N + 3, device=cuda)
    world = despawn_where(app.reg, app.init_state(),
                          torch.from_numpy(np.random.default_rng(3).random(N + 3) < 0.1)
                          .to(cuda), 0)
    ib, sb = _lane_inputs(app, 3, K, seed=4, dev=cuda)
    _, stacked, checks = app.speculate_fn(world, ib, sb, 0)
    flat = tree_map(lambda a: a.reshape(3 * K, *a.shape[2:]), stacked)
    names = [n for n, c in app.reg.components.items() if c.checksum]
    args = fold_inputs(app.reg, flat, names)
    got = cf.checksum_fold(*args)
    assert torch.equal(got, cf.checksum_fold_plain(*args))
    assert torch.equal(branch_checksums(app.reg, stacked), checks)


@pytest.mark.parametrize("mode", ["fast", "canonical-branched"])
def test_hedged_pair_makes_no_host_sync_and_never_desyncs(cuda, mode):
    """Both peers hedge on the default path (pipelined; packed in fast
    mode, the one [B, K + 1, W] upload in canonical-branched mode): the
    steady loop runs under sync debug mode "error", with hits, no forced
    read, no staging wait, one upload per resim and per draft, no
    desync."""
    spec = SpeculationConfig(candidates_fn=pad_candidates(2, [0, 1], [1, 8]), depth=4)

    def make():
        if mode == "fast":
            return stress_soa.make_app(n_entities=N, device=cuda)
        app = stress_soa.make_app(n_entities=N, canonical_depth=10, device=cuda)
        app.canonical_branches = 5  # lane 0 and the four candidates
        return app

    net, runners = _flipping_pair(make, cuda, speculation=spec)
    for _ in range(30):
        net.deliver()
        for r in runners:
            r.update(1 / 60)
    before = [r.stats() for r in runners]
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(60):
            net.deliver()
            for r in runners:
                r.update(1 / 60)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    after = [r.stats() for r in runners]
    for r in runners:
        r.finish()
    for r, b, a in zip(runners, before, after):
        assert a["readbacks"]["forced"] == b["readbacks"]["forced"]
        assert a["staging_deferred_blocks"] == b["staging_deferred_blocks"]
        assert a["host_uploads"] - b["host_uploads"] == \
            a["device_dispatches"] - b["device_dispatches"]
        assert r.spec_cache.host_uploads == r.spec_cache.draft_dispatches
        assert a["donated_dispatches"] == 0
    assert after[1]["speculation_hits"] > before[1]["speculation_hits"]
    assert not [e for r in runners for e in r.events if isinstance(e, DesyncDetected)]


# -- many worlds (the lobby axis) --------------------------------------------------


def _packed_wave(app, starts, k, seed):
    spec = app.packed_spec
    rng = np.random.default_rng(seed)
    m = len(starts)
    inputs = rng.integers(0, 16, (m, k, app.num_players)).astype(app.input_dtype)
    status = np.zeros((m, k, app.num_players), np.int8)
    buf = spec.new_batch_buffer(m, k)
    for b in range(m):
        pack_prefix(buf[b], starts[b], k)
        for i in range(k):
            pack_row(spec, buf[b], i, inputs[b, i], status[b, i])
    return buf, inputs, status


def _clock_app(dev):
    """A step that writes its clock (frame, retire horizon, time) into
    every entity and folds its inputs and the frame into a running value,
    so a lane on another lane's clock, inputs or world shows."""
    import dataclasses

    from bevy_ggrs_tpu_torch import App
    from bevy_ggrs_tpu_torch.snapshot import spawn

    app = App(num_players=2, capacity=4, input_shape=(), input_dtype=np.uint8, retention=5,
              fps=60, device=dev)
    for name, dt in (("f", torch.int32), ("r", torch.int32), ("t", torch.float32),
                     ("acc", torch.int32)):
        app.rollback_component(name, (), dt)

    def step(world, ctx):
        c = world.comps
        one = torch.ones_like(c["f"])
        mix = ctx.inputs.to(torch.int32).sum() * 7 + ctx.frame
        return dataclasses.replace(world, comps={
            "f": one * ctx.frame, "r": one * ctx.retire_frame,
            "t": torch.ones_like(c["t"]) * ctx.time_seconds,
            "acc": (c["acc"] * 31 + mix) & 0xFFFF})

    def setup(world):
        for _ in range(2):
            world, _ = spawn(app.reg, world, {"f": 0, "r": 0, "t": 0.0, "acc": 0})
        return world

    app.set_step(step)
    app.set_setup(setup)
    return app


@pytest.mark.parametrize("model", ["stress_soa", "fixed_point", "clock"])
def test_wave_lanes_equal_solo_resims_on_card(cuda, model):
    """Every lane of a packed exact wave (its clock read on the card from
    its prefix, starts straddling I32_MAX, each lane from its own world)
    equals the solo resim of that world bit for bit, with one fold launch
    for the wave; the clock app's time holds the lanes' f32 division to
    the solo path's host division."""
    from bevy_ggrs_tpu_torch import BucketedWaveExecutor, stack_worlds, unstack_world

    app = (stress_soa.make_app(n_entities=N, device=cuda) if model == "stress_soa"
           else fixed_point.make_app(device=cuda) if model == "fixed_point"
           else _clock_app(cuda))
    starts = [0, 7, 2**31 - 2, -(2**31) + 5]
    buf, inputs, status = _packed_wave(app, starts, K, seed=3)
    inputs, status = torch.from_numpy(inputs).to(cuda), torch.from_numpy(status).to(cuda)
    worlds = [app.init_state()]
    for b in range(1, 4):
        worlds.append(app.resim_fn(worlds[0], inputs[b, :b], status[b, :b], 100 * b)[0])
    ex = BucketedWaveExecutor(app, K)
    cf.launches = 0
    tr.vmap_fallbacks = 0
    _b, finals, stacked, checks = ex.run_wave_packed(stack_worlds(worlds), buf, [K] * 4)
    torch.cuda.synchronize()
    assert cf.launches == 1 and tr.vmap_fallbacks == 0 and checks.shape == (4 * K, 2)
    for b in range(4):
        final, solo_stacked, solo_checks = app.resim_fn(worlds[b], inputs[b], status[b],
                                                        starts[b])
        assert _trees_equal(unstack_world(finals, b), final), b
        assert _trees_equal(unstack_world(stacked, b), solo_stacked), b
        assert torch.equal(checks[b * K:(b + 1) * K], solo_checks), b


def test_fold_on_wave_stack_equals_plain(cuda):
    from bevy_ggrs_tpu_torch import BucketedWaveExecutor, stack_worlds

    app = stress_soa.make_app(n_entities=N, device=cuda)
    buf, _i, _s = _packed_wave(app, [0, 50, 100], K, seed=4)
    ex = BucketedWaveExecutor(app, K)
    _b, _f, stacked, checks = ex.run_wave_packed(stack_worlds([app.init_state()] * 3), buf,
                                                 [K] * 3)
    flat = tree_map(lambda a: a.reshape(3 * K, *a.shape[2:]), stacked)
    args = fold_inputs(app.reg, flat, [n for n, s in app.reg.components.items() if s.checksum])
    assert torch.equal(cf.checksum_fold(*args), cf.checksum_fold_plain(*args))
    assert torch.equal(checks, world_checksums(app.reg, flat))


def test_batched_runner_launches_flat_in_lobby_count(cuda):
    """The same SyncTest traffic at M=4 and M=16 lobbies launches the same
    kernels and copies per steady tick (the profiler's count)."""
    from torch.profiler import ProfilerActivity, profile

    from bevy_ggrs_tpu_torch import BatchedRunner, SyncTestSession
    from bevy_ggrs_tpu_torch.models import stress

    counts = {}
    for m in (4, 16):
        br = BatchedRunner(stress.make_app(64, capacity=64, device=cuda),
                           [SyncTestSession(2, check_distance=2) for _ in range(m)],
                           read_inputs=lambda b, hs: {h: np.uint8((b + h) & 0xF) for h in hs})
        for _ in range(4):
            br.tick()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(6):
                br.tick()
            torch.cuda.synchronize()
        counts[m] = sum(e.count for e in prof.key_averages()
                        if e.device_type == torch.autograd.DeviceType.CUDA
                        and not getattr(e, "is_user_annotation", False))
    assert counts[4] == counts[16] > 0, counts


# -- the megastep and the game surface ---------------------------------------------


def _megastep_synctest(make, megastep, cuda, ticks=40, coalesce=1):
    from bevy_ggrs_tpu_torch import SyncTestSession

    app = make()
    # every comparison deferred to finish(), after the sync-checked loop
    session = SyncTestSession(num_players=2, input_shape=(), input_dtype=np.uint8,
                              check_distance=4, compare_interval=2 * ticks)
    runner = GgrsRunner(app, session,
                        read_inputs=lambda hs: {h: np.uint8((runner.frame // 3 + h) & 0xF)
                                                for h in hs},
                        on_mismatch=lambda e: (_ for _ in ()).throw(e),
                        megastep=megastep, coalesce_frames=coalesce)
    cf.launches = 0  # the runner's initial world checksum is not the path's
    refs = []
    for t in range(ticks // coalesce):
        if megastep and t >= 2:
            # past the first dispatches' allocations, the megastep loop
            # (the step included) makes no host sync
            torch.cuda.set_sync_debug_mode("error")
        try:
            runner.update(coalesce / 60)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        refs.append(runner._world_checksum)
    runner.finish()
    return runner, [ref() for ref in refs], cf.launches


@pytest.mark.parametrize("model", ["stress_soa", "particles", "crowd", "pong"])
def test_megastep_equals_per_tick_runner_on_card(cuda, model):
    """SyncTest (a fused load every tick) and coalesced flushes: the
    megastep's checksum stream is the per-tick runner's, bit for bit; one
    fold launch and one upload per megastep dispatch."""
    from bevy_ggrs_tpu_torch.models import crowd, particles, pong

    make = {"stress_soa": lambda: stress_soa.make_app(n_entities=N, device=cuda),
            "particles": lambda: particles.make_app(rate=50, ttl=20, device=cuda),
            "crowd": lambda: crowd.make_app(n_per_team=256, device=cuda),
            "pong": lambda: pong.make_app(device=cuda)}[model]
    for coalesce in (1, 4):
        ms, a, launches = _megastep_synctest(make, True, cuda, coalesce=coalesce)
        _, b, _ = _megastep_synctest(make, False, cuda, coalesce=coalesce)
        assert a == b
        st = ms.stats()
        assert st["fused_ring_loads"] > 0
        assert launches == st["megastep_dispatches"] == st["host_uploads"] > 0


def test_megastep_capture_replays_bit_exact(cuda):
    """One megastep call captured in a CUDA graph and replayed with a
    fused-load prefix and a plain one equals the eager call on the same
    ring, output for output."""
    from bevy_ggrs_tpu_torch.models import particles
    from bevy_ggrs_tpu_torch.ops.megastep import init_device_ring, make_megastep_fn
    from bevy_ggrs_tpu_torch.ops.packing import repeat_last_row

    app = particles.make_app(rate=64, ttl=10, device=cuda)
    k_max, slots = 6, 9
    fn = make_megastep_fn(app.reg, app.step, app.packed_spec, app.fps, seed=app.seed,
                          retention=app.retention, k_max=k_max, ring_slots=slots)
    spec = app.packed_spec
    host = torch.zeros((k_max + 1, spec.width), dtype=torch.int8).pin_memory()
    rows = torch.zeros((k_max + 1, spec.width), dtype=torch.int8, device=cuda)

    def stage(start, n, load=0, slot=0):
        buf = host.numpy()
        pack_prefix(buf, start, n, load, slot)
        for i in range(n):
            pack_row(spec, buf, i, np.array([i, 3], np.uint8), np.zeros(2, np.int8))
        repeat_last_row(buf, n, k_max)
        rows.copy_(host)

    world = app.init_state()
    ring, tags = init_device_ring(world, slots)
    stage(0, k_max)
    world, ring, tags, _, _ = fn(world, ring, tags, rows)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(world, tree_map(lambda t: t.clone(), ring), tags.clone(), rows)  # warm-up
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        cap = fn(world, ring, tags, rows)
    for prefix in ((2, 4, 1, 2), (k_max + 1, 3, 0, 0)):
        ring0, tags0 = [t.clone() for t in tree_flatten(ring)], tags.clone()
        stage(*prefix)
        graph.replay()
        got = [t.clone() for t in tree_flatten((cap[0], cap[3]))] + [cap[4].clone()] + [
            t.clone() for t in tree_flatten(ring)] + [tags.clone()]
        for t, w in zip(tree_flatten(ring), ring0):
            t.copy_(w)
        tags.copy_(tags0)
        out = fn(world, ring, tags, rows)
        want = tree_flatten((out[0], out[3])) + [out[4]] + tree_flatten(ring) + [tags]
        assert len(got) == len(want) and all(torch.equal(x, y) for x, y in zip(got, want))


def test_particles_draws_on_card_equal_cpu(cuda):
    """threefry's draws on the card are the CPU's bits (which the CPU tests
    hold to ``jax.random``)."""
    from bevy_ggrs_tpu_torch.utils import threefry

    for c in (0, 5, 2**31 + 1, 2**32 - 1):
        out = []
        for dev in (cuda, torch.device("cpu")):
            kv, kp = threefry.split(threefry.fold_in(threefry.prng_key(0),
                                                     torch.tensor(c, device=dev)))
            out.append([threefry.uniform(kv, (101, 3), -2.0, 2.0).cpu(),
                        threefry.uniform(kp, (101,)).cpu(),
                        threefry.random_bits(kv, (7,)).cpu()])
        for a, b in zip(*out):
            assert torch.equal(a, b)


def test_crowd_lanes_against_solo_on_card(cuda):
    """A wave of crowd lobbies runs with no ``vmap`` fallback; each lane is
    compared with its solo resim.  Bit-equality is recorded, not required:
    long reductions may round with the lane count (ROADMAP queue C); the
    lanes stay within 1e-4 of the solo runs."""
    from bevy_ggrs_tpu_torch.models import crowd
    from bevy_ggrs_tpu_torch.ops import batch as TB

    app = crowd.make_app(n_per_team=512, device=cuda)
    m, k = 8, 6
    rng = np.random.default_rng(2)
    inputs = torch.as_tensor(rng.integers(0, 16, (m, k, 2)).astype(np.uint8)).to(cuda)
    status = torch.zeros((m, k, 2), dtype=torch.int8, device=cuda)
    starts = torch.arange(m, dtype=torch.int32, device=cuda) * 5
    worlds = [app.init_state() for _ in range(m)]
    tr.vmap_fallbacks = 0
    _, stacked, checks = TB.make_batched_resim_fn(app)(TB.stack_worlds(worlds), inputs,
                                                       status, starts)
    assert tr.vmap_fallbacks == 0
    for b in range(m):
        _, one, _ = app.resim_fn(worlds[b], inputs[b], status[b], int(starts[b]))
        for x, y in zip(tree_flatten(one), tree_flatten(TB.unstack_world(stacked, b))):
            if x.dtype.is_floating_point:
                assert float((x - y).abs().max()) <= 1e-4
            else:
                assert torch.equal(x, y)


# -- telemetry on the card ----------------------------------------------------


@pytest.fixture
def telemetry_on():
    from bevy_ggrs_tpu_torch import telemetry

    telemetry.reset()
    telemetry.enable()
    yield telemetry
    telemetry.disable()
    telemetry.reset()
    telemetry.configure_forensics(None)


def test_telemetry_pair_makes_no_host_sync_and_reconciles(cuda, telemetry_on):
    """Telemetry on, the default path still ticks under sync debug mode
    "error" with no forced read and no staging wait; one fold launch per
    resim; the blame sums to the rollbacks; the phases reconcile to wall
    time; the ring row is ring frames times world bytes and the strict
    census passes against the allocator."""
    telemetry = telemetry_on
    from bevy_ggrs_tpu_torch.telemetry import devmem

    net, runners = _flipping_pair(lambda: stress_soa.make_app(n_entities=N, device=cuda),
                                  cuda)
    for _ in range(30):
        net.deliver()
        for r in runners:
            r.update(1 / 60)
    before = [r.stats() for r in runners]
    cf.launches = 0
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(60):
            net.deliver()
            for r in runners:
                r.update(1 / 60)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    after = [r.stats() for r in runners]
    resims = sum(a["device_dispatches"] - b["device_dispatches"]
                 for a, b in zip(after, before))
    assert cf.launches == resims > 0
    for b, a in zip(before, after):
        assert a["readbacks"]["forced"] == b["readbacks"]["forced"]
        assert a["staging_deferred_blocks"] == b["staging_deferred_blocks"]
        t = a["phases"]
        assert abs(t["wall_seconds"] - sum(t["phase_seconds"].values())
                   - t["unattributed_seconds"]) < 1e-4
    snap = telemetry.registry().snapshot()
    total = sum(snap["rollbacks_total"]["series"].values())
    assert total == sum(snap["rollback_cause_total"]["series"].values())
    assert total == sum(r.rollbacks for r in runners) > 0
    for r in runners:
        assert devmem.snapshot()[r._devmem_tag + "/snapshot_ring"] == \
            len(r.ring.frames()) * r._world_nbytes
    c = devmem.census(strict=True)
    assert c["live_bytes"] == torch.cuda.memory_allocated() >= c["registered_bytes"] > 0
    for r in runners:
        r.finish()
    assert not [e for r in runners for e in r.events if isinstance(e, DesyncDetected)]


def test_census_strict_flags_a_stale_row_on_card(cuda, telemetry_on):
    from bevy_ggrs_tpu_torch.telemetry import devmem

    x = torch.zeros(1 << 20, device=cuda)
    devmem.note("test/buffer", x.numel() * x.element_size())
    assert devmem.census(strict=True, device=cuda)["registered_bytes"] == 4 << 20
    devmem.note("test/buffer", torch.cuda.memory_allocated(cuda) + 1)
    with pytest.raises(RuntimeError, match="stale"):
        devmem.census(strict=True, device=cuda)
    del x


def test_forensics_report_on_card_equals_plain_and_cpu(cuda, telemetry_on, tmp_path):
    """A forced desync on the card: both peers write a report (each into
    its own directory), each report's per-component parts come from the
    fold kernel (two launches) and equal the CPU's computation on a copy
    of the same world; the merge names ``pos``."""
    import dataclasses
    import json

    from bevy_ggrs_tpu_torch.snapshot.lazy import wrap_single_checksum
    from bevy_ggrs_tpu_torch.telemetry import forensics

    telemetry = telemetry_on
    seen = []
    original = forensics.component_checksums

    def keeping(reg, world):
        before = cf.launches
        got = original(reg, world)
        seen.append((reg, world, got, cf.launches - before))
        return got

    forensics.component_checksums = keeping
    dirs = [tmp_path / "p0", tmp_path / "p1"]
    try:
        net, runners = _flipping_pair(lambda: box_game.make_app(device=cuda), cuda)

        def step():
            net.deliver()
            for d, r in zip(dirs, runners):
                telemetry.configure_forensics(str(d))
                r.update(1 / 60)

        for _ in range(40):
            step()
        r0 = runners[0]
        w = r0.world
        r0.world = dataclasses.replace(w, comps={**w.comps, "pos": w.comps["pos"] + 0.5})
        r0._world_checksum = wrap_single_checksum(r0.app.checksum_fn(r0.world))
        for _ in range(60):
            step()
            if all(isinstance(e, DesyncDetected) for r in runners for e in r.events[-1:]):
                break
    finally:
        forensics.component_checksums = original
    reports = [sorted(d.glob("desync_p2p_desync_*.json")) for d in dirs]
    assert all(reports)
    assert seen and all(launches == 2 for *_x, launches in seen)
    for reg, world, got, _n in seen:
        assert got == original(reg, tree_map(lambda a: a.cpu(), world))
    merged = telemetry.merge_reports(str(reports[0][0]), str(reports[1][0]))
    assert merged["first_divergent_frame"] is not None
    assert "pos" in merged["component_diff"]
    assert all(json.loads(p.read_text())["component_checksums"] for ps in reports for p in ps)
