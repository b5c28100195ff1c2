"""The port's branch axis and speculation cache against the JAX package.

Mirrors ``tests/test_speculation.py`` and ``tests/test_speculation_budget.py``
and holds the port's ``speculate_fn``, ``packed_speculate_fn`` and
``branched_fn`` to the JAX package's ``make_speculate_fn``,
``make_packed_speculate_fn`` and ``make_canonical_branched_fn`` on the same
seeded inputs (numpy ``default_rng``):

- port against port, bit for bit: each lane of the branch axis equals the
  plain ``resim_fn`` (or ``resim_padded`` at the lane's ``n_real``) on that
  lane's inputs, states, finals and checksums;
- port against JAX: integer models (``fixed_point``, a despawning counter)
  bit for bit, states and checksums; float models (``box_game``,
  ``stress_soa``, ``stress``) within ``atol=1e-4, rtol=0`` on their states
  (XLA on the CPU contracts ``a*b + c`` into FMAs, eager torch does not;
  ROADMAP queue C), and the port's checksums of the JAX stacked states
  equal to the JAX checksums exactly (the checksum is exact on identical
  bits).

Also: the cache's byte budget and frame cap, eviction and invalidation
across the i32 frame wrap, ``pad_candidates`` against the JAX function,
one fold call per branch-axis call, the ``vmap`` fallback census, and the
clear error of a step that cannot run on the branch axis."""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bevy_ggrs_tpu_torch.ops.resim as tr
import bevy_ggrs_tpu_torch.snapshot.checksum as t_checksum
from bevy_ggrs_tpu import App as JApp
from bevy_ggrs_tpu import GgrsRunner as JRunner
from bevy_ggrs_tpu import pad_candidates as j_pad_candidates
from bevy_ggrs_tpu.models import box_game as j_box_game
from bevy_ggrs_tpu.models import fixed_point as j_fixed_point
from bevy_ggrs_tpu.models import stress as j_stress
from bevy_ggrs_tpu.models import stress_soa as j_stress_soa
from bevy_ggrs_tpu.ops.packing import PackedSpec as JPackedSpec
from bevy_ggrs_tpu.snapshot import active_mask as j_active_mask
from bevy_ggrs_tpu.snapshot import despawn_where as j_despawn_where
from bevy_ggrs_tpu.snapshot import spawn as j_spawn
from bevy_ggrs_tpu_torch import (
    App,
    GgrsRunner,
    SessionState,
    SpeculationCache,
    SpeculationConfig,
    pad_candidates,
    select_branch,
    slice_frame,
)
from bevy_ggrs_tpu_torch.convert import world_from_numpy, world_to_numpy
from bevy_ggrs_tpu_torch.models import box_game, fixed_point, stress, stress_soa
from bevy_ggrs_tpu_torch.ops.packing import (
    PackedUpload,
    pack_prefix,
    pack_row,
    prefix_words,
    unpack_seq,
)
from bevy_ggrs_tpu_torch.session.events import InputStatus
from bevy_ggrs_tpu_torch.session.requests import AdvanceRequest, SaveCell, SaveRequest
from bevy_ggrs_tpu_torch.snapshot import (
    active_mask,
    branch_checksums,
    despawn_where,
    spawn,
    world_checksums,
)
from bevy_ggrs_tpu_torch.utils.frames import I32_MAX, I32_MIN
from bevy_ggrs_tpu_torch.utils.tree import tree_flatten, tree_unflatten

jr = importlib.import_module("bevy_ggrs_tpu.ops.resim")

FLOAT_ATOL = 1e-4  # FMA contraction in XLA's CPU code, absent in torch eager
M, K = 4, 5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run this file's small tensors on one intra-op thread: the suite runs
    in several worker processes, and idle OpenMP threads spinning here
    would take cores from the wall-clock-driven games of other files."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _status(k, p):
    return np.full((k, p), InputStatus.CONFIRMED, np.int8)


def _counter_apps():
    """An int32 counter per player that despawns at frame 4: the despawn
    sweep and a despawn inside the step, on the branch axis too."""

    def make(AppCls, spawn_fn, despawn, active, where, i32, cast, **kw):
        app = AppCls(num_players=2, capacity=4, retention=3, **kw)
        app.rollback_component("counter", (), i32, checksum=True)

        def step(world, ctx):
            mask = active(world) & world.has["counter"]
            cnt = where(mask, world.comps["counter"] + cast(ctx.inputs[0]),
                        world.comps["counter"])
            world = dataclasses.replace(world, comps={"counter": cnt})
            return despawn(app.reg, world, mask & (ctx.frame == 4), ctx.frame)

        app.set_step(step)
        app.set_setup(lambda w: spawn_fn(app.reg, spawn_fn(app.reg, w, {"counter": 0})[0],
                                         {"counter": 5})[0])
        return app

    return (make(JApp, j_spawn, j_despawn_where, j_active_mask, jnp.where, jnp.int32,
                 lambda x: x.astype(jnp.int32)),
            make(App, spawn, despawn_where, active_mask, torch.where, torch.int32,
                 lambda x: x.to(torch.int32), device="cpu"))


def _apps(model):
    """(JAX app, port app, exact?) for one model at a small size."""
    if model == "fixed_point":
        return j_fixed_point.make_app(), fixed_point.make_app(device="cpu"), True
    if model == "counter":
        return (*_counter_apps(), True)
    if model == "box_game":
        return j_box_game.make_app(), box_game.make_app(device="cpu"), False
    if model == "stress_soa":
        return (j_stress_soa.make_app(n_entities=256),
                stress_soa.make_app(n_entities=256, device="cpu"), False)
    assert model == "stress"
    return (j_stress.make_app(256, capacity=300),
            stress.make_app(256, capacity=300, device="cpu"), False)


MODELS = ["fixed_point", "counter", "box_game", "stress_soa", "stress"]


def _branch_inputs(app, m, k, seed):
    rng = np.random.default_rng(seed)
    inputs = rng.integers(0, 16, (m, k, app.num_players, *app.input_shape))
    status = rng.integers(0, 2, (m, k, app.num_players))
    return inputs.astype(app.input_dtype), status.astype(np.int8)


def _jax_leaves(w) -> dict:
    return {f.name: jax.tree.map(np.asarray, getattr(w, f.name))
            for f in dataclasses.fields(w)}


def _j_ints(checks):
    c = np.asarray(checks).astype(np.uint64)
    return ((c[..., 0] << np.uint64(32)) | c[..., 1]).tolist()


def _t_ints(checks):
    c = checks.numpy().astype(np.uint64)
    return ((c[..., 0] << np.uint64(32)) | c[..., 1]).tolist()


def _assert_trees_equal(a, b):
    for x, y in zip(tree_flatten(a), tree_flatten(b), strict=True):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


def _assert_like_jax(jtree, ttree, exact):
    """Port world (leading axes kept) against the JAX one: components bit
    for bit or within FLOAT_ATOL, every other leaf bit for bit."""
    want, got = _jax_leaves(jtree), world_to_numpy(ttree)
    for field in ("comps", "has"):
        for n in want[field]:
            a, b = want[field][n], got[field][n]
            assert a.dtype == b.dtype and a.shape == b.shape, (field, n)
            if exact or field == "has":
                assert np.array_equal(a, b), (field, n)
            else:
                np.testing.assert_allclose(b, a, rtol=0, atol=FLOAT_ATOL, err_msg=n)
    for field in ("alive", "rollback_id", "despawn_pending", "despawn_frame", "next_id"):
        assert np.array_equal(want[field], got[field]), field


def _assert_checks_like_jax(treg, jstacked, jchecks, tchecks, exact):
    """Checksums bit for bit where the states are; else the port's
    checksums of the JAX states equal the JAX checksums."""
    if exact:
        assert _t_ints(tchecks) == _j_ints(jchecks)
        return
    m, k = np.asarray(jchecks).shape[:2]
    leaves = _jax_leaves(jstacked)
    flat = jax.tree.map(lambda a: a.reshape(m * k, *a.shape[2:]), leaves)
    carried = world_from_numpy(treg, flat, "cpu")
    assert _t_ints(world_checksums(treg, carried).view(m, k, 2)) == _j_ints(jchecks)


# -- tests/test_speculation.py -------------------------------------------------


def test_selected_branch_matches_direct_resim():
    japp = j_box_game.make_app(num_players=2)
    app = box_game.make_app(num_players=2, device="cpu")
    k, m = 4, 5
    candidates = [box_game.keys_to_input(), box_game.keys_to_input(left=True),
                  box_game.keys_to_input(right=True), box_game.keys_to_input(up=True),
                  box_game.keys_to_input(down=True)]
    branches = np.zeros((m, k, 2), np.uint8)
    branches[:, :, 0] = box_game.keys_to_input(right=True)
    for b in range(m):
        branches[b, :, 1] = candidates[b]
    statuses = np.broadcast_to(_status(k, 2), (m, k, 2)).copy()
    world = app.init_state()
    finals, stacked, checks = app.speculate_fn(world, branches, statuses, 0)
    direct_final, direct_stacked, direct_checks = app.resim_fn(
        world, branches[3], statuses[3], 0)
    _assert_trees_equal(select_branch(finals, 3), direct_final)
    _assert_trees_equal(select_branch(stacked, 3), direct_stacked)
    assert torch.equal(checks[3], direct_checks)
    assert not torch.equal(checks[0], checks[3])  # distinct branches diverge
    jfinals, jstacked, jchecks = japp.speculate_fn(japp.init_state(), branches,
                                                   statuses, 0, -1)
    _assert_like_jax(jfinals, finals, exact=False)
    _assert_checks_like_jax(app.reg, jstacked, jchecks, checks, exact=False)


def test_stacked_states_are_per_frame_saves():
    app = box_game.make_app(num_players=2, device="cpu")
    world = app.init_state()
    k = 3
    inputs = np.full((k, 2), box_game.keys_to_input(up=True), np.uint8)
    _, stacked, checks = app.resim_fn(world, inputs, _status(k, 2), 0)
    w = world
    for i in range(k):
        w, cs = app.advance_fn(w, inputs[i], _status(1, 2)[0], i + 1)
        assert torch.equal(cs, checks[i])
        _assert_trees_equal(w, slice_frame(stacked, i))


# -- the branch axis against the plain resim and the JAX package --------------


@pytest.mark.parametrize("model", MODELS)
def test_speculate_lanes_equal_resim_and_jax(model):
    japp, app, exact = _apps(model)
    inputs, status = _branch_inputs(app, M, K, seed=MODELS.index(model))
    world = app.init_state()
    finals, stacked, checks = app.speculate_fn(world, inputs, status, 7)
    assert checks.shape == (M, K, 2)
    for b in range(M):
        f, s, c = app.resim_fn(world, inputs[b], status[b], 7)
        _assert_trees_equal(select_branch(finals, b), f)
        _assert_trees_equal(select_branch(stacked, b), s)
        assert torch.equal(checks[b], c)
    jfinals, jstacked, jchecks = japp.speculate_fn(japp.init_state(), inputs, status, 7, -1)
    _assert_like_jax(jstacked, stacked, exact)
    _assert_like_jax(jfinals, finals, exact)
    _assert_checks_like_jax(app.reg, jstacked, jchecks, checks, exact)


def _packed_batch(spec, inputs, status, start):
    m, k = inputs.shape[:2]
    buf = spec.new_batch_buffer(m, k)
    for b in range(m):
        pack_prefix(buf[b], start, k)
        for i in range(k):
            pack_row(spec, buf[b], i, inputs[b, i], status[b, i])
    return buf


@pytest.mark.parametrize("model", ["fixed_point", "box_game"])
def test_packed_speculate_equals_unpacked_and_jax(model):
    japp, app, exact = _apps(model)
    inputs, status = _branch_inputs(app, M, K, seed=11)
    buf = _packed_batch(app.packed_spec, inputs, status, -3)
    jspec = JPackedSpec.for_app(japp)
    assert jspec.new_batch_buffer(M, K).shape == buf.shape
    t_in, t_st = unpack_seq(app.packed_spec, torch.from_numpy(buf))
    assert np.array_equal(t_in.numpy(), inputs) and np.array_equal(t_st.numpy(), status)
    world = app.init_state()
    packed = PackedUpload(torch.from_numpy(buf.copy()), *prefix_words(buf[0]))
    got = app.packed_speculate_fn(world, packed)
    want = app.speculate_fn(world, inputs, status, -3)
    _assert_trees_equal(got, want)
    jfinals, jstacked, jchecks = japp.packed_speculate_fn(japp.init_state(), buf)
    _assert_like_jax(jstacked, got[1], exact)
    _assert_checks_like_jax(app.reg, jstacked, jchecks, got[2], exact)


@pytest.mark.parametrize("model", ["fixed_point", "counter", "box_game"])
def test_canonical_branched_lanes_equal_padded_resim_and_jax(model):
    japp, app, exact = _apps(model)
    lanes, depth = 4, 6
    inputs, status = _branch_inputs(app, lanes, depth, seed=5)
    n_real = [3, 6, 6, 0]  # lane 0 real, two hedges, a lane that never advances
    world = app.init_state()
    fn = tr.make_canonical_branched_fn(app.reg, app.step, app.fps, app.retention,
                                       depth, lanes)
    finals, stacked, checks = fn(world, inputs, status, 2, n_real)
    for b in range(lanes):
        f, s, c = tr.resim_padded(app.reg, app.step, world, inputs[b], status[b], 2,
                                  n_real[b], app.retention, app.fps)
        _assert_trees_equal(select_branch(finals, b), f)
        _assert_trees_equal(select_branch(stacked, b), s)
        assert torch.equal(checks[b], c)
    jfn = jr.make_canonical_branched_fn(japp.reg, japp.step, japp.fps, 0, japp.retention,
                                        depth, lanes)
    jfinals, jstacked, jchecks = jfn(japp.init_state(), inputs, status, 2,
                                     np.array(n_real, np.int32))
    _assert_like_jax(jstacked, stacked, exact)
    _assert_like_jax(jfinals, finals, exact)
    _assert_checks_like_jax(app.reg, jstacked, jchecks, checks, exact)
    with pytest.raises(ValueError, match="lanes x frames"):
        fn(world, inputs[:2], status[:2], 2, n_real[:2])


@pytest.mark.parametrize("model", ["fixed_point", "box_game"])
def test_branched_resim_facade_equals_canonical_resim(model):
    _, plain, _ = _apps(model)
    _, branched, _ = _apps(model)
    plain.canonical_depth = 8
    branched.canonical_depth, branched.canonical_branches = 8, 3
    assert branched.packed_resim_fn is None and branched.resim_fn_donated is None
    assert branched.packed_speculate_fn is None
    inputs, status = _branch_inputs(plain, 1, 5, seed=1)
    for k in (1, 5):
        want = plain.resim_fn(plain.init_state(), inputs[0, :k], status[0, :k], 4)
        got = branched.resim_fn(branched.init_state(), inputs[0, :k], status[0, :k], 4)
        assert got[2].shape == (k, 2)
        _assert_trees_equal(got, want)
    w, cs = branched.advance_fn(branched.init_state(), inputs[0, 0], status[0, 0], 5)
    w2, cs2 = plain.advance_fn(plain.init_state(), inputs[0, 0], status[0, 0], 5)
    assert torch.equal(cs, cs2)
    _assert_trees_equal(w, w2)


def test_canonical_branches_requires_canonical_depth():
    with pytest.raises(ValueError, match="requires canonical_depth"):
        App(canonical_branches=4, device="cpu")
    with pytest.raises(RuntimeError, match="canonical_branches"):
        box_game.make_app(device="cpu").branched_fn


def test_branch_checksums_is_one_fold_call(monkeypatch):
    app = stress_soa.make_app(n_entities=300, device="cpu")
    inputs, status = _branch_inputs(app, M, K, seed=3)
    calls = []
    fold = t_checksum.checksum_fold
    monkeypatch.setattr(t_checksum, "checksum_fold",
                        lambda *a: calls.append(a[2].shape) or fold(*a))
    _, stacked, checks = app.speculate_fn(app.init_state(), inputs, status, 0)
    assert calls == [(M * K, 300)]
    for b in range(M):
        lane = select_branch(stacked, b)
        assert torch.equal(world_checksums(app.reg, lane), checks[b])
    assert torch.equal(branch_checksums(app.reg, stacked), checks)


def test_shipped_models_need_no_vmap_fallback_and_one_is_counted():
    tr.vmap_fallbacks = 0
    for model in MODELS:
        _, app, _ = _apps(model)
        inputs, status = _branch_inputs(app, 2, 2, seed=0)
        app.speculate_fn(app.init_state(), inputs, status, 0)
    assert tr.vmap_fallbacks == 0
    app = stress_soa.make_app(n_entities=64, device="cpu")
    step = app.step

    def histogram_step(world, ctx):  # torch.histc has no batching rule
        world = step(world, ctx)
        h = torch.histc(world.comps["x"] + ctx.inputs[0].to(torch.float32), bins=4)
        return dataclasses.replace(world, comps={**world.comps,
                                                 "x": world.comps["x"] + 0 * h[0]})

    app.set_step(histogram_step)
    inputs, status = _branch_inputs(app, 2, 3, seed=0)
    _, _, checks = app.speculate_fn(app.init_state(), inputs, status, 0)
    assert tr.vmap_fallbacks == 3  # one per frame, and the result still right
    assert torch.equal(checks[1], app.resim_fn(app.init_state(), inputs[1], status[1], 0)[2])
    tr.vmap_fallbacks = 0


def test_step_that_cannot_batch_raises_at_first_speculate():
    app = App(num_players=2, capacity=4, device="cpu")
    app.rollback_component("c", (), torch.int32, checksum=True)

    def step(world, ctx):
        col = world.comps["c"].clone()
        col[0] = ctx.inputs[0].to(torch.int32)  # a batched value into an unbatched column
        return dataclasses.replace(world, comps={"c": col})

    app.set_step(step)
    inputs, status = _branch_inputs(app, 2, 2, seed=0)
    assert app.resim_fn(app.init_state(), inputs[0], status[0], 0)[2].shape == (2, 2)
    with pytest.raises(RuntimeError, match="branch axis"):
        app.speculate_fn(app.init_state(), inputs, status, 0)


def test_tree_flatten_round_trips_in_field_order():
    _, app, _ = _apps("counter")
    w = app.init_state()
    leaves = tree_flatten(w)
    again = tree_unflatten(w, leaves)
    _assert_trees_equal(again, w)
    assert leaves[0] is w.comps["counter"]


# -- tests/test_speculation_budget.py -------------------------------------------


def _cache(n_entities, **cfg_kwargs):
    app = stress.make_app(n_entities, capacity=n_entities, device="cpu")
    config = SpeculationConfig(
        candidates_fn=lambda last: np.stack([np.bitwise_xor(last, v) for v in (0, 1, 2, 3)]),
        depth=2, **cfg_kwargs)
    return app, SpeculationCache(app, config)


def _fill(app, cache, frames):
    world = app.init_state()
    used = np.zeros((2,), np.uint8)
    for f in frames:
        cache.speculate(world, f, used)
    return world


def test_budget_evicts_oldest_and_respects_cap():
    app, cache = _cache(4096, max_cached_frames=64)
    _fill(app, cache, [0])
    per_entry = cache.cached_bytes
    assert per_entry > 0 and cache.host_uploads == 1 and cache.draft_dispatches == 1
    cache.config.max_cached_bytes = int(per_entry * 2.5)
    _fill(app, cache, [1, 2, 3, 4])
    assert cache.cached_bytes <= cache.config.max_cached_bytes
    assert sorted(cache._cache) == [3, 4]  # oldest-first eviction
    assert cache.bytes_evicted >= 3 * per_entry
    assert cache.branches_evaluated == 5 * 4 * 2


def test_newest_entry_survives_undersized_budget():
    app, cache = _cache(4096, max_cached_frames=64, max_cached_bytes=1)
    _fill(app, cache, [0, 1])
    assert sorted(cache._cache) == [1]  # never empty, newest kept
    assert cache.lookup(1, np.zeros((2,), np.uint8)) is not None


def test_budget_under_live_runner_large_world():
    """A large world (32,768 entities; the JAX test's 100,000 took ~50 s
    here under six test workers) whose hedge entries dwarf a tiny budget
    keeps hedging each tick while holding at most one entry."""
    n = 32_768
    app = stress.make_app(n, capacity=n, device="cpu")

    class PredictingSession:
        """Every tick: save + advance with the remote input PREDICTED."""

        def __init__(self):
            self.frame = 0

        def num_players(self):
            return 2

        def max_prediction(self):
            return 8

        def confirmed_frame(self):
            return -1

        def current_state(self):
            return SessionState.RUNNING

        def local_player_handles(self):
            return [0]

        def add_local_input(self, handle, value):
            pass

        def _on_cell_saved(self, frame, provider):
            pass

        def advance_frame(self):
            status = np.zeros((2,), np.int8)
            status[1] = InputStatus.PREDICTED
            reqs = [SaveRequest(self.frame, SaveCell(self, self.frame)),
                    AdvanceRequest(np.zeros((2,), np.uint8), status)]
            self.frame += 1
            return reqs

    runner = GgrsRunner(
        app, PredictingSession(), read_inputs=lambda hs: {h: np.uint8(0) for h in hs},
        speculation=SpeculationConfig(
            candidates_fn=lambda last: np.stack([np.bitwise_xor(last, v) for v in (0, 1)]),
            depth=1, max_cached_bytes=1))
    for _ in range(6):
        runner.tick()
    s = runner.stats()
    assert len(runner.spec_cache._cache) <= 1
    assert runner.spec_cache.bytes_evicted > 0
    assert s["speculation_draft_dispatches"] == 6
    assert s["speculation_cached_bytes"] <= max(runner.spec_cache._entry_bytes.values(),
                                                default=0)


# -- pad_candidates, wrapping frames -----------------------------------------------


@pytest.mark.parametrize("handles,values", [([1], list(range(16))), ([0, 1], [0, 3, 9]),
                                            ([1], [2])])
def test_pad_candidates_equal_jax(handles, values):
    used = np.array([5, 7], np.uint8)
    got = pad_candidates(2, handles, values)(used)
    want = j_pad_candidates(2, handles, values)(used)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    vec = np.arange(6, dtype=np.int16).reshape(2, 3)
    assert np.array_equal(pad_candidates(2, handles, values)(vec),
                          j_pad_candidates(2, handles, values)(vec))


def test_eviction_and_invalidation_across_the_i32_wrap():
    app, cache = _cache(64, max_cached_frames=3)
    frames = [I32_MAX - 2, I32_MAX - 1, I32_MAX, I32_MIN, I32_MIN + 1]
    _fill(app, cache, frames)
    # the three newest under wrapping order survive (sorted() would keep
    # the three largest ints, the oldest frames)
    assert set(cache._cache) == {I32_MAX, I32_MIN, I32_MIN + 1}
    cache.invalidate_after(I32_MAX)  # a rollback to the last frame before the wrap
    assert set(cache._cache) == {I32_MAX}
    assert cache.cached_bytes == cache._entry_bytes[I32_MAX] > 0
    cache.clear()
    assert cache.cached_bytes == 0 and not cache._cache


def test_cache_on_a_canonical_app_splits_the_upload_for_the_plain_program():
    """A canonical app has no packed speculate program: the cache splits
    its one upload and calls ``speculate_fn``; the entries are the same."""
    plain = box_game.make_app(device="cpu")
    canonical = box_game.make_app(canonical_depth=8, device="cpu")
    assert canonical.packed_speculate_fn is None
    cfg = SpeculationConfig(candidates_fn=pad_candidates(2, [1], [0, 4, 8]), depth=3)
    caches = [SpeculationCache(app, cfg) for app in (plain, canonical)]
    for cache, app in zip(caches, (plain, canonical)):
        cache.speculate(app.init_state(), 5, np.array([8, 0], np.uint8))
        assert cache.host_uploads == cache.draft_dispatches == 1
    (_, a), (_, b) = caches[0]._cache[5], caches[1]._cache[5]
    assert a.keys() == b.keys()
    for key in a:
        _assert_trees_equal(a[key], b[key])


def test_lookup_seq_serves_the_constant_prefix_only():
    app = box_game.make_app(device="cpu")
    cache = SpeculationCache(app, SpeculationConfig(
        candidates_fn=pad_candidates(2, [1], [0, 4, 8]), depth=4))
    world = app.init_state()
    cache.speculate(world, 10, np.array([8, 0], np.uint8))
    seq = np.array([[8, 4], [8, 4], [8, 1], [8, 4]], np.uint8)
    d, states_fn, checks = cache.lookup_seq(10, seq)
    assert d == 2 and checks.shape == (4, 2)
    _, s, c = app.resim_fn(world, np.repeat(seq[:1], 4, axis=0), np.zeros((4, 2), np.int8), 10)
    _assert_trees_equal(states_fn(1), slice_frame(s, 1))
    assert torch.equal(checks, c)
    assert cache.lookup_seq(10, np.array([[8, 5]], np.uint8)) is None  # unhedged
    assert cache.lookup_seq(11, seq) is None  # no entry
    assert (cache.hits, cache.misses) == (1, 2)


def test_plain_cache_refused_under_canonical_depth_as_in_jax():
    from bevy_ggrs_tpu import SpeculationConfig as JSpeculationConfig

    japp = j_box_game.make_app()
    japp.canonical_depth = 8
    with pytest.raises(ValueError, match="canonical-branched"):
        JRunner(japp, speculation=JSpeculationConfig(
            candidates_fn=j_pad_candidates(2, [1], [0, 1])))
    with pytest.raises(ValueError, match="canonical-branched"):
        GgrsRunner(box_game.make_app(canonical_depth=8, device="cpu"),
                   speculation=SpeculationConfig(candidates_fn=pad_candidates(2, [1], [0, 1])))
    app = box_game.make_app(canonical_depth=8, device="cpu")
    app.canonical_branches = 3
    runner = GgrsRunner(app, speculation=SpeculationConfig(
        candidates_fn=pad_candidates(2, [1], [0, 1])))
    assert runner.spec_cache is not None and not runner.packed
