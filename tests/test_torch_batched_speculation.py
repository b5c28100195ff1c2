"""The port BatchedRunner's idle-lane drafts, held against a plain batched
run and the JAX package's BatchedRunner.

Mirrors ``tests/test_batched_speculation.py`` (all three tests): a draft
wave hedges a predicted transition into the lane the active bucket left
idle, and a Load whose corrected run was fully hedged is served from the
branch cache, bit for bit what a plain (speculation-less) batched run
computes; an unhedged correction misses and takes the fused-load path;
the mode matrix refuses what it must.  Each scripted run also runs on the
JAX BatchedRunner (``pipeline=False``): the lobby's frames, world and
re-saved checksums match it (``box_game`` floats within ``atol=1e-4,
rtol=0``, XLA's FMAs; checksums of ``fixed_point`` exact).  Besides: the
drafts' counters, and each lobby's cache entries as a copy of its own
lanes of the draft wave (never views pinning the whole wave stack), each
the solo resim of its candidate."""

import dataclasses

import numpy as np
import pytest
import torch

import bevy_ggrs_tpu as J
import bevy_ggrs_tpu_torch as T
import bevy_ggrs_tpu_torch.snapshot as TS
from bevy_ggrs_tpu.models import box_game as j_box_game
from bevy_ggrs_tpu.models import fixed_point as j_fixed_point
from bevy_ggrs_tpu.ops.speculation import SpeculationConfig as JSpeculationConfig
from bevy_ggrs_tpu.ops.speculation import pad_candidates as j_pad_candidates
from bevy_ggrs_tpu.session.requests import LoadRequest as JLoad
from bevy_ggrs_tpu.session.requests import SaveCell as JSaveCell
from bevy_ggrs_tpu.session.requests import SaveRequest as JSave
from bevy_ggrs_tpu_torch import BatchedRunner, SpeculationConfig, pad_candidates
from bevy_ggrs_tpu_torch.models import box_game, fixed_point
from bevy_ggrs_tpu_torch.session.requests import LoadRequest, SaveCell, SaveRequest
from bevy_ggrs_tpu_torch.utils.mem import tree_device_bytes, tree_storage_bytes
from bevy_ggrs_tpu_torch.utils.tree import tree_leaves
from tests.test_speculative_runner import ScriptedSession as JScriptedSession
from tests.test_speculative_runner import adv as j_adv
from tests.test_torch_speculative_runner import ScriptedSession, adv

RIGHT = box_game.keys_to_input(right=True)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rollback_script(holder, corrected, pkg=T):
    """Tick 1: save(0) + a predicted advance.  Tick 2: the real remote
    input arrives: rollback to 0, the corrected frame, the live frame."""
    predicted, actual = [RIGHT, 0], [RIGHT, corrected]
    if pkg is T:
        Load, Save, Cell, a = LoadRequest, SaveRequest, SaveCell, adv
    else:
        Load, Save, Cell, a = JLoad, JSave, JSaveCell, j_adv

    def save(f):
        return Save(f, Cell(holder[0], f))

    tick1 = [save(0), a(predicted, predicted=True)]
    tick2 = [Load(0), a(actual), save(1), a(actual, predicted=True)]
    return [tick1, tick2]


def _run_pair(speculation, corrected, pkg=T, model="box_game"):
    """Two lobbies: lobby 0 runs the rollback script, lobby 1 stays idle;
    its lane is the spare capacity the draft wave fills."""
    if pkg is T:
        app = (box_game if model == "box_game" else fixed_point).make_app(device="cpu")
        s0, s1 = ScriptedSession([]), ScriptedSession([[], []])
        kw = {}
    else:
        app = (j_box_game if model == "box_game" else j_fixed_point).make_app()
        s0, s1 = JScriptedSession([]), JScriptedSession([[], []])
        kw = {"pipeline": False}
    s0.script = _rollback_script([s0], corrected, pkg)
    br = pkg.BatchedRunner(app, [s0, s1], speculation=speculation, **kw)
    br.tick()
    br.tick()
    return br


def _spec(values, depth=4, pkg=T):
    if pkg is T:
        return SpeculationConfig(candidates_fn=pad_candidates(2, [1], values), depth=depth)
    return JSpeculationConfig(candidates_fn=j_pad_candidates(2, [1], values), depth=depth)


def _assert_like_jax(br, jbr, exact):
    assert br.frames == jbr.frames
    got, want = br.lobby_world(0), jbr.lobby_world(0)
    for n in got.comps:
        np.testing.assert_allclose(got.comps[n].numpy(), np.asarray(want.comps[n]),
                                   rtol=0, atol=0 if exact else 1e-4, err_msg=n)
    if exact:
        assert br.lobby_checksum(0) == jbr.lobby_checksum(0)
        assert br.sessions[0].saved[1]() == jbr.sessions[0].saved[1]()


@pytest.mark.parametrize("model", ["box_game", "fixed_point"])
def test_batched_cache_hit_matches_plain_run(model):
    corrected = box_game.keys_to_input(up=True)
    br_spec = _run_pair(_spec([corrected]), corrected, model=model)
    br_plain = _run_pair(None, corrected, model=model)
    st = br_spec.stats()["speculation"]
    assert st["hits"] == 1 and st["misses"] == 0
    assert st["draft_waves"] >= 1 and st["draft_lanes_filled"] >= 1
    assert st["cache_served_frames"] == 2  # the corrected frame + the live frame
    assert br_spec.frames == br_plain.frames == [2, 0]
    assert br_spec.lobby_checksum(0) == br_plain.lobby_checksum(0)
    for n in br_spec.lobby_world(0).comps:
        assert torch.equal(br_spec.lobby_world(0).comps[n], br_plain.lobby_world(0).comps[n])
    # the re-saved frame-1 checksum: a view of the branch stack on the hit
    # path, a wave batch's row on the plain path
    assert br_spec.sessions[0].saved[1]() == br_plain.sessions[0].saved[1]()
    # the frame-1 ring entry is a view of the lobby's copy of its draft lane
    stored, _cs = br_spec.rings[0].peek(1)
    assert isinstance(stored, TS.lazy.LazySlice)
    jbr = _run_pair(_spec([corrected], pkg=J), corrected, J, model)
    assert jbr.stats()["speculation"]["hits"] == 1
    _assert_like_jax(br_spec, jbr, model == "fixed_point")


def test_batched_cache_miss_on_unhedged_input_falls_back():
    corrected = np.uint8(9)  # UP|RIGHT: not among the hedged values
    br_spec = _run_pair(_spec([0, 1, 2, 3]), corrected)
    br_plain = _run_pair(None, corrected)
    st = br_spec.stats()["speculation"]
    assert st["hits"] == 0 and st["misses"] >= 1
    assert br_spec.frames == br_plain.frames == [2, 0]
    assert br_spec.lobby_checksum(0) == br_plain.lobby_checksum(0)
    assert br_spec.sessions[0].saved[1]() == br_plain.sessions[0].saved[1]()
    assert br_spec.stats()["fused_loads"] == 1
    jbr = _run_pair(_spec([0, 1, 2, 3], pkg=J), corrected, J)
    assert jbr.stats()["speculation"]["misses"] >= 1
    _assert_like_jax(br_spec, jbr, False)


def test_batched_speculation_mode_matrix():
    app = box_game.make_app(device="cpu")
    with pytest.raises(ValueError, match="packed=True"):
        BatchedRunner(app, [ScriptedSession([])], packed=False, speculation=_spec([1]))
    with pytest.raises(ValueError, match="k_max"):
        BatchedRunner(app, [ScriptedSession([])], k_max=2, speculation=_spec([1], depth=8))
    qapp = T.App(num_players=1, capacity=4, input_shape=(), input_dtype=np.uint8,
                 device="cpu")
    qapp.rollback_component("x", (), torch.float32, strategy=T.QuantizeStrategy(),
                            checksum=True)

    def step(world, ctx):
        m = TS.active_mask(world)
        return dataclasses.replace(world, comps={
            "x": torch.where(m & world.has["x"], world.comps["x"] + 1.0, world.comps["x"])})

    qapp.set_step(step)
    with pytest.raises(ValueError, match="identity snapshot"):
        BatchedRunner(qapp, [ScriptedSession([], num_players=1)],
                      speculation=SpeculationConfig(candidates_fn=pad_candidates(1, [0], [1])))


def test_draft_counters_and_views():
    """Per tick one draft wave at most, only into idle lanes; candidates
    that do not fit are dropped and counted; the cache holds a copy of the
    lobby's own lane, never a view pinning the whole wave stack."""
    corrected = box_game.keys_to_input(up=True)
    br = _run_pair(_spec(list(range(4))), corrected)
    st = br.stats()["speculation"]
    # one idle lane (lobby 1) for 4 candidates: 1 drafted, 3 dropped per wave
    assert st["draft_lanes_filled"] == st["draft_waves"] == 2
    assert st["dropped_candidates"] == 3 * st["draft_waves"]
    assert st["cached_bytes"] > 0
    cache = br.spec_caches[0]
    for _f, (_depth, entry) in cache._cache.items():
        for stacked, checks in entry.values():
            # the lobby's one lane: no other lane of the [M, bucket] stack
            alive = stacked.alive
            assert alive.untyped_storage().nbytes() == alive.numel() * alive.element_size()
            assert checks.shape == (4, 2)
    assert br.stats()["wave_dispatches"] == br.stats()["host_uploads"]


def test_draft_entries_hold_only_their_lobbys_lanes():
    """Two lobbies draft two candidates each into one wave, their lanes
    interleaved among four idle ones: each lobby's cache holds a copy of
    its own lanes (its storages are its entries' bytes, shared with no
    other lobby), and each entry is the solo resim of its candidate from
    the lobby's pre-advance state (a misrouted lane would show)."""
    depth = 3
    values = [box_game.keys_to_input(up=True), box_game.keys_to_input(left=True)]
    cfg = _spec(values, depth=depth)
    app = fixed_point.make_app(device="cpu")
    sessions = [ScriptedSession([]) for _ in range(2)] + [ScriptedSession([[]]) for _ in range(4)]
    for s in sessions[:2]:
        s.script = _rollback_script([s], values[0])[:1]
    br = BatchedRunner(app, sessions, speculation=cfg)
    br.tick()
    st = br.stats()["speculation"]
    assert st["draft_lanes_filled"] == 4 and st["dropped_candidates"] == 0
    cands = cfg.candidates_fn(np.asarray([RIGHT, 0], np.uint8))
    storages = []
    for b in (0, 1):
        cache = br.spec_caches[b]._cache
        assert tree_storage_bytes(cache) == tree_device_bytes(cache) > 0
        storages.append({a.untyped_storage().data_ptr() for a in tree_leaves(cache)
                         if isinstance(a, torch.Tensor)})
        (start, (d, entry)), = cache.items()
        assert start == 0 and d == depth and len(entry) == len(cands)
        for c in cands:
            _f, solo, solo_checks = app.resim_fn(
                app.init_state(), np.repeat(c[None], depth, 0), np.zeros((depth, 2), np.int8), 0)
            stacked, checks = entry[np.ascontiguousarray(c).tobytes()]
            assert torch.equal(checks, solo_checks)
            for n in solo.comps:
                assert torch.equal(stacked.comps[n], solo.comps[n]), (b, n)
    assert not storages[0] & storages[1]
