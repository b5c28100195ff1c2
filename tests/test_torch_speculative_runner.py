"""The port runner's speculation seams on scripted sessions, on the CPU.

Mirrors ``tests/test_speculative_runner.py``,
``tests/test_speculation_stale_cache.py`` and
``tests/test_speculation_service.py`` (all five cases):

- a hedged depth-1 rollback is served from the cache and equals a plain
  runner's resim bit for bit (world, checksum, resaved frames); an
  unhedged correction misses and still resimulates; a depth-k cache serves
  a whole k-frame rollback with no resim;
- a rollback drops the branches hedged from superseded states, so a
  speculating runner's ring never parts from a plain one's (the schedule
  that desynced before the JAX package's fix);
- repeated hedged rollbacks on the default path (pipelined, packed) equal
  the sync unpacked runner; a SyncTest with speculation is all-miss and
  records only miss service times; a disconnect rollback invalidates the
  superseded entry; the mode matrix refuses what it must; input-queue
  rotation with a cache stays bit-identical with one upload per resim;
- besides: no donation while a cache is present, one packed upload per
  draft, the cache cleared with a new session, and the hedged runner's
  states against the JAX runner's (``fixed_point`` bit for bit;
  ``box_game`` within ``atol=1e-4, rtol=0``, XLA's FMAs; queue C).

Port against port is bit for bit everywhere."""

import numpy as np
import pytest
import torch

from bevy_ggrs_tpu import GgrsRunner as JRunner
from bevy_ggrs_tpu.models import box_game as j_box_game
from bevy_ggrs_tpu.models import fixed_point as j_fixed_point
from bevy_ggrs_tpu.session.requests import AdvanceRequest as JAdvance
from bevy_ggrs_tpu.session.requests import LoadRequest as JLoad
from bevy_ggrs_tpu.session.requests import SaveCell as JSaveCell
from bevy_ggrs_tpu.session.requests import SaveRequest as JSave
from bevy_ggrs_tpu_torch import (
    GgrsRunner,
    SessionState,
    SpeculationConfig,
    SyncTestSession,
    pad_candidates,
)
from bevy_ggrs_tpu_torch.models import box_game, fixed_point
from bevy_ggrs_tpu_torch.session.events import InputStatus
from bevy_ggrs_tpu_torch.session.requests import (
    AdvanceRequest,
    LoadRequest,
    RollbackCause,
    SaveCell,
    SaveRequest,
)
from bevy_ggrs_tpu_torch.utils import staging
from tests.test_torch_packing import ring_checksums, synctest_runner

RIGHT = box_game.keys_to_input(right=True)
FLOAT_ATOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run this file's small tensors on one intra-op thread: the suite runs
    in several worker processes, and idle OpenMP threads spinning here
    would take cores from the wall-clock-driven games of other files."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class ScriptedSession:
    """A session that emits a fixed request script, one entry per tick."""

    def __init__(self, script=(), num_players=2):
        self.script = list(script)
        self._num_players = num_players
        self.tick_idx = 0
        self.saved = {}
        self.conf = -1

    def num_players(self):
        return self._num_players

    def max_prediction(self):
        return 8

    def confirmed_frame(self):
        return self.conf

    def current_state(self):
        return SessionState.RUNNING

    def local_player_handles(self):
        return [0]

    def add_local_input(self, handle, value):
        pass

    def advance_frame(self):
        reqs = self.script[self.tick_idx]
        self.tick_idx += 1
        return reqs

    def _on_cell_saved(self, frame, provider):
        self.saved[frame] = provider


def adv(inputs, predicted=False, cls=AdvanceRequest):
    status = np.zeros((2,), np.int8)
    if predicted:
        status[1] = InputStatus.PREDICTED
    return cls(np.asarray(inputs, np.uint8), status)


def make_deep_script(session, corrected, depth, reqs=None):
    """``depth`` live frames on a predicted (idle) remote, then the real,
    constant remote input arrives for all of them: a depth-``depth``
    rollback and the next live frame.  ``reqs`` picks the request classes
    (the port's or the JAX package's)."""
    Adv, Load, Save, Cell = reqs or (AdvanceRequest, LoadRequest, SaveRequest, SaveCell)
    predicted, actual = [RIGHT, 0], [RIGHT, corrected]

    def save(f):
        return Save(f, Cell(session, f))

    ticks = [[save(f), adv(predicted, True, Adv)] for f in range(depth)]
    rollback = [Load(0)]
    for f in range(depth):
        rollback += [adv(actual, cls=Adv), save(f + 1)]
    rollback.append(adv(actual, True, Adv))
    ticks.append(rollback)
    return ticks


def run_deep(speculation, depth=1, corrected=None, make_app=None, **kw):
    app = (make_app or (lambda: box_game.make_app(device="cpu")))()
    session = ScriptedSession()
    session.script = make_deep_script(
        session, box_game.keys_to_input(up=True) if corrected is None else corrected, depth)
    runner = GgrsRunner(app, session, speculation=speculation, **kw)
    for _ in range(depth + 1):
        runner.tick()
    runner.finish()
    return runner


def assert_runners_equal(a, b):
    assert a.frame == b.frame
    for n in a.world.comps:
        assert torch.equal(a.world.comps[n], b.world.comps[n]), n
    assert a.checksum == b.checksum
    assert sorted(a.session.saved) == sorted(b.session.saved)
    for f in a.session.saved:
        assert a.session.saved[f]() == b.session.saved[f](), f


# -- tests/test_speculative_runner.py --------------------------------------------


def test_cache_hit_matches_plain_resim():
    spec = SpeculationConfig(candidates_fn=pad_candidates(2, [1], list(range(16))))
    r_spec = run_deep(spec)
    r_plain = run_deep(None)
    assert r_spec.spec_cache.hits == 1 and r_spec.frame == r_plain.frame == 2
    assert r_spec.cache_served_frames == 1
    assert_runners_equal(r_spec, r_plain)
    # the corrected frame was not resimulated: the rollback's resim ran
    # the live frame only
    assert r_spec.rollback_frames == 0 < r_plain.rollback_frames
    assert r_spec.resims == r_plain.resims


def test_cache_miss_on_unhedged_input():
    spec = SpeculationConfig(candidates_fn=pad_candidates(2, [1], [0, 1, 2, 3]))
    runner = run_deep(spec, corrected=np.uint8(9))  # UP|RIGHT, not hedged
    assert runner.spec_cache.hits == 0 and runner.spec_cache.misses >= 1
    assert_runners_equal(runner, run_deep(None, corrected=np.uint8(9)))


@pytest.mark.parametrize("pipeline", [True, False])
def test_depth_k_cache_serves_whole_rollback(pipeline):
    depth = 3
    spec = SpeculationConfig(candidates_fn=pad_candidates(2, [1], list(range(16))), depth=4)
    r_spec = run_deep(spec, depth, pipeline=pipeline)
    r_plain = run_deep(None, depth)
    # the corrected frames and the live frame hold one input, so one cached
    # branch serves all depth + 1 advances: the last tick runs no resim
    assert r_spec.spec_cache.hits == 1 and r_spec.cache_served_frames == depth + 1
    assert r_spec.resims == r_plain.resims - 1 and r_spec.rollback_frames == 0
    assert_runners_equal(r_spec, r_plain)
    st = r_spec.stats()
    assert st["speculation_hits"] == 1 and st["cache_served_frames"] == depth + 1
    assert st["speculation_draft_dispatches"] == st["speculation_host_uploads"] == depth + 1


@pytest.mark.parametrize("model", ["fixed_point", "box_game"])
def test_hedged_runner_against_jax_plain_runner(model):
    """The port's hedged runner against the JAX runner with no cache and
    ``pipeline=False`` on the same depth-3 script."""
    depth = 3
    mods = {"fixed_point": (fixed_point, j_fixed_point), "box_game": (box_game, j_box_game)}
    tmod, jmod = mods[model]
    spec = SpeculationConfig(candidates_fn=pad_candidates(2, [1], list(range(16))), depth=4)
    r_spec = run_deep(spec, depth, make_app=lambda: tmod.make_app(device="cpu"))
    assert r_spec.cache_served_frames == depth + 1
    session = ScriptedSession()
    session.script = make_deep_script(session, box_game.keys_to_input(up=True), depth,
                                      (JAdvance, JLoad, JSave, JSaveCell))
    jr = JRunner(jmod.make_app(), session, pipeline=False)
    for _ in range(depth + 1):
        jr.tick()
    assert jr.frame == r_spec.frame
    for n in r_spec.world.comps:
        got, want = r_spec.world.comps[n].numpy(), np.asarray(jr.world.comps[n])
        if model == "fixed_point":
            assert np.array_equal(got, want), n
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=FLOAT_ATOL, err_msg=n)
    if model == "fixed_point":
        assert r_spec.checksum == jr.checksum
        for f in range(1, depth + 1):
            assert r_spec.session.saved[f]() == session.saved[f]()


def test_runner_with_cache_never_donates_and_uploads_once_per_draft():
    spec = SpeculationConfig(candidates_fn=pad_candidates(2, [1], [0, 4, 8]), depth=2)
    runner = run_deep(spec, 3)
    st = runner.stats()
    assert st["donated_dispatches"] == 0 and st["device_dispatches"] > 0
    assert runner.spec_cache.host_uploads == runner.spec_cache.draft_dispatches > 0
    w = runner.app.packed_spec.width
    assert runner.spec_cache.packed_upload_bytes == runner.spec_cache.draft_dispatches * 3 * 3 * w
    assert run_deep(None, 3).stats()["donated_dispatches"] > 0


def test_new_session_clears_the_cache():
    spec = SpeculationConfig(candidates_fn=pad_candidates(2, [1], [0, 4]), depth=2)
    runner = run_deep(spec, 2)
    assert runner.spec_cache._cache
    runner.set_session(ScriptedSession())
    assert not runner.spec_cache._cache and runner.spec_cache.cached_bytes == 0


# -- tests/test_speculation_stale_cache.py -----------------------------------------


def _stale_runner(spec):
    r = GgrsRunner(box_game.make_app(device="cpu"), read_inputs=lambda hs: {},
                   speculation=spec)
    r.session = ScriptedSession()
    return r


def test_rollback_invalidates_branches_from_predicted_states():
    spec = SpeculationConfig(candidates_fn=pad_candidates(2, [1], list(range(8))),
                             depth=4, max_cached_frames=16)
    a, b = _stale_runner(spec), _stale_runner(None)
    rng = np.random.default_rng(0)
    true_inp = {}

    def tin(f):
        if f not in true_inp:
            true_inp[f] = rng.integers(0, 8, size=2).astype(np.uint8)
        return true_inp[f]

    def advance(f, predicted_from=None):
        inp = tin(f).copy()
        st = np.full((2,), InputStatus.CONFIRMED, np.int8)
        if predicted_from is not None:
            inp[1] = tin(predicted_from)[1]  # repeat-last prediction
            st[1] = InputStatus.PREDICTED
        return AdvanceRequest(inp, st)

    def batch(reqs, confirmed):
        for r in (a, b):
            r.session.conf = confirmed
            r._handle_requests(list(reqs))

    def assert_rings_agree(tag):
        for f in set(a.ring.frames()) & set(b.ring.frames()):
            assert a.ring.peek(f)[1]() == b.ring.peek(f)[1](), f"diverged at frame {f} ({tag})"

    conf, last_real, cur = -1, 0, 0
    for t in range(1, 120):
        if cur - last_real < 8:
            batch([SaveRequest(cur, SaveCell(a.session, cur)),
                   advance(cur + 1, predicted_from=last_real)], conf)
            cur += 1
            assert_rings_agree(f"live tick {t}")
        if t % 3 == 0:
            j = int(rng.integers(1, 4))
            newconf = min(last_real + j, cur - 1)
            if newconf > last_real:
                target, k = last_real, cur - last_real
                reqs = [LoadRequest(target)]
                for i in range(1, k + 1):
                    f = target + i
                    reqs.append(advance(f, predicted_from=None if f <= newconf else newconf))
                    reqs.append(SaveRequest(f, SaveCell(a.session, f)))
                batch(reqs, target)
                last_real = conf = newconf
                assert_rings_agree(f"rollback tick {t}")
    assert a.spec_cache.hits >= 1  # the schedule exercised the cache


# -- tests/test_speculation_service.py (all five cases) ---------------------------


def make_rounds_script(session, correcteds):
    """Rounds of (predicted advance -> corrected rollback): every second
    tick rolls back and re-advances with the real remote input."""
    ticks, f = [], 0

    def save(fr):
        return SaveRequest(fr, SaveCell(session, fr))

    for corrected in correcteds:
        actual = [RIGHT, corrected]
        ticks.append([save(f), adv([RIGHT, 0], predicted=True)])
        ticks.append([LoadRequest(f), adv(actual), save(f + 1), adv(actual, predicted=True)])
        f += 2
    return ticks


def _run_rounds(speculation, correcteds, **kw):
    session = ScriptedSession()
    session.script = make_rounds_script(session, correcteds)
    runner = GgrsRunner(box_game.make_app(device="cpu"), session, speculation=speculation,
                        **kw)
    for _ in range(2 * len(correcteds)):
        runner.tick()
    runner.finish()
    return runner


def test_repeated_hedged_rollbacks_bit_identical_to_sync_unpacked():
    correcteds = [1, 2, 9, 5]
    spec = SpeculationConfig(candidates_fn=pad_candidates(2, [1], list(range(16))), depth=4)
    r_spec = _run_rounds(spec, correcteds, pipeline=True, packed=True,
                         measure_rollback_service=True)
    r_plain = _run_rounds(None, correcteds, pipeline=False, packed=False)
    assert r_spec.spec_cache.hits == len(correcteds)
    assert r_spec.frame == r_plain.frame == 2 * len(correcteds)
    assert_runners_equal(r_spec, r_plain)
    service = r_spec.stats()["rollback_service_ms"]
    assert service["hit"]["n"] == len(correcteds) and service["miss"]["n"] == 0
    assert 0 < service["hit"]["p50"] <= service["hit"]["p99"]


def test_synctest_oracle_with_speculation_is_all_miss():
    """SyncTest's inputs are all CONFIRMED, so no draft fires: every
    structural rollback misses, and the oracle proves the miss path."""
    spec = SpeculationConfig(candidates_fn=pad_candidates(2, [1], list(range(16))), depth=4)
    r_spec, s_spec = synctest_runner(box_game.make_app(device="cpu"), packed=True,
                                     speculation=spec, measure_rollback_service=True)
    r_plain, s_plain = synctest_runner(box_game.make_app(device="cpu"), packed=False)
    assert s_spec == s_plain and ring_checksums(r_spec) == ring_checksums(r_plain)
    assert r_spec.spec_cache.hits == 0 and r_spec.spec_cache.misses > 0
    assert r_spec.spec_cache.draft_dispatches == 0
    service = r_spec.stats()["rollback_service_ms"]
    assert service["miss"]["p50"] is not None and service["hit"]["p50"] is None


def test_invalidate_after_mid_speculation_disconnect():
    session = ScriptedSession()
    actual = [RIGHT, 7]  # not hedged below: the disconnect load misses

    def save(f):
        return SaveRequest(f, SaveCell(session, f))

    session.script = [
        [save(0), adv([RIGHT, 0], predicted=True)],
        [save(1), adv([RIGHT, 0], predicted=True)],
        [LoadRequest(0, cause=RollbackCause(handle=1, lateness=2, kind="disconnect")),
         adv(actual), save(1), adv(actual), save(2), adv(actual)],
    ]
    spec = SpeculationConfig(candidates_fn=pad_candidates(2, [1], [0, 1, 2, 3]), depth=4)
    runner = GgrsRunner(box_game.make_app(device="cpu"), session, speculation=spec)
    runner.tick()
    runner.tick()
    cache = runner.spec_cache
    assert set(cache._cache) == {0, 1}  # one branch set per predicted tick
    runner.tick()
    # the frame-1 entry hedged a superseded prediction and is gone; the
    # frame-0 entry's base is the state the load restores
    assert set(cache._cache) == {0}
    assert cache.misses >= 1 and runner.rollbacks_by_cause == {1: 1}
    assert cache.cached_bytes == cache._entry_bytes[0] > 0


def test_solo_mode_matrix():
    sess = SyncTestSession(num_players=2)
    with pytest.raises(ValueError, match="input_queue"):
        GgrsRunner(box_game.make_app(device="cpu"), sess, packed=False, input_queue=True)
    spec = SpeculationConfig(candidates_fn=pad_candidates(2, [1], [1]))
    with pytest.raises(ValueError, match="canonical-branched"):
        GgrsRunner(box_game.make_app(canonical_depth=8, device="cpu"),
                   SyncTestSession(num_players=2), speculation=spec)
    with pytest.raises(ValueError, match="packed program"):
        app = box_game.make_app(canonical_depth=8, device="cpu")
        app.canonical_branches = 3
        GgrsRunner(app, SyncTestSession(num_players=2), packed=True, speculation=spec)


def test_input_queue_bit_identical_and_census():
    spec = SpeculationConfig(candidates_fn=pad_candidates(2, [1], [1, 2]), depth=2)
    q, qs = synctest_runner(fixed_point.make_app(device="cpu"), input_queue=True,
                            speculation=spec)
    plain, ps = synctest_runner(fixed_point.make_app(device="cpu"), packed=False)
    assert qs == ps and ring_checksums(q) == ring_checksums(plain)
    st = q.stats()
    assert st["input_queue"] is True
    assert st["host_uploads"] == st["device_dispatches"]
    assert st["staging_deferred_blocks"] + st["staging_landed_free"] > 0


def test_speculating_pipeline_under_the_sanitizer():
    """Draft uploads go through staging: an armed sanitizer sees no race
    on a speculating pipelined runner."""
    san = staging.set_sanitize(True)
    try:
        spec = SpeculationConfig(candidates_fn=pad_candidates(2, [1], list(range(16))),
                                 depth=4)
        r_spec = _run_rounds(spec, [1, 2, 9, 5, 3, 3])
        assert san.violations == 0 and r_spec.spec_cache.hits == 6
    finally:
        staging.set_sanitize(False)


# -- the hit path's saves follow the reference's clone rule ---------------------


def _ring_kinds(runner, lazy_cls):
    """``{frame: True for a view of a stack, False for a clone}`` of a
    runner's ring."""
    return {f: isinstance(stored, lazy_cls)
            for f, (stored, _cs) in zip(runner.ring._frames, runner.ring._snapshots)}


@pytest.mark.parametrize("cache_depth,guard_frames", [(4, 4), (2, 4), (2, 1)],
                         ids=["full-hit", "partial-hit", "partial-hit-guarded"])
def test_hit_path_keeps_views_where_the_jax_runner_does(cache_depth, guard_frames):
    """The hedged depth-3 pair on both packages with the ring guard set
    between the resim stack's bytes and the draft entry's: a served save is
    cloned only when the run's own resim stack passes the guard (never on a
    full hit, which has no stack), as in the JAX runner.  After every tick
    each ring entry is a view on one side exactly where it is on the
    other.  ``guard_frames`` counts one world's bytes (1 minus a byte: the
    2-frame resim stack of the partial hit passes it)."""
    from bevy_ggrs_tpu.snapshot.lazy import LazySlice as JLazySlice
    from bevy_ggrs_tpu_torch.snapshot.lazy import LazySlice
    from bevy_ggrs_tpu_torch.utils.mem import tree_device_bytes

    depth = 3
    world_bytes = tree_device_bytes(box_game.make_app(device="cpu").init_state())
    guard = guard_frames * world_bytes - (1 if guard_frames == 1 else 0)
    up = box_game.keys_to_input(up=True)
    cands = list(range(16))
    port_sess, jax_sess = ScriptedSession(), ScriptedSession()
    port_sess.script = make_deep_script(port_sess, up, depth)
    jax_sess.script = make_deep_script(jax_sess, up, depth,
                                       (JAdvance, JLoad, JSave, JSaveCell))
    port = GgrsRunner(box_game.make_app(device="cpu"), port_sess,
                      speculation=SpeculationConfig(
                          candidates_fn=pad_candidates(2, [1], cands), depth=cache_depth))
    from bevy_ggrs_tpu.ops.speculation import SpeculationConfig as JSpeculationConfig
    from bevy_ggrs_tpu.ops.speculation import pad_candidates as j_pad_candidates

    jr = JRunner(j_box_game.make_app(), jax_sess, pipeline=False,
                 speculation=JSpeculationConfig(
                     candidates_fn=j_pad_candidates(2, [1], cands), depth=cache_depth))
    # the guard lies below the draft entry (16 lanes x cache_depth frames)
    assert guard < 16 * cache_depth * world_bytes
    port.ring_materialize_bytes = jr.ring_materialize_bytes = guard
    for _ in range(depth + 1):
        port.tick()
        jr.tick()
        assert _ring_kinds(port, LazySlice) == _ring_kinds(jr, JLazySlice)
    assert port.spec_cache.hits == jr.spec_cache.hits == 1
    assert port.cache_served_frames == jr.cache_served_frames == min(cache_depth, depth + 1)
    assert port.frame == jr.frame == depth + 1
    kinds = _ring_kinds(port, LazySlice)
    served = [f for f in range(1, depth + 1) if f <= cache_depth]
    # a full hit and an unguarded partial hit keep every served save a view
    assert all(kinds[f] for f in served) == (cache_depth > depth or guard_frames > 1)
    # frame 0 is the initial world itself (a leading save), never a clone
    assert port.materialized_saves == sum(not kinds[f] for f in kinds if f > 0)
