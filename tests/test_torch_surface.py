"""The port's public surface against the JAX package's.

Names: every public name a JAX package ``__init__`` binds (top level,
``ops``, ``utils``, ``snapshot``, ``session``, ``telemetry``, ``fleet``,
``parallel``) resolves on the port's package of the same path.  For every
module both packages have, every public function, class and class method
the JAX module defines resolves in the port's module, and takes every
parameter the JAX one takes.  The allowlist holds the deliberate
differences only, each with its reason: parameters that only XLA has, and
JAX-only tree helpers.

Behaviour, with inputs from a numpy seed, held against the JAX package on
the CPU: ``make_advance_fn`` over 8 frames (``fixed_point`` bit for bit;
``stress_soa`` states within ``atol=1e-4, rtol=0``, XLA's FMA contraction,
and the port's checksum of the JAX states' bits equal to the JAX
checksum); the module-level ``pong.step`` over a 200-frame rally, held the
same way; and the port alone: ``set_tracing``, ``trace_log`` and the
deprecated shims, ``GgrsRunner.profile``, ``checksum_peek``,
``readback_stats`` and ``staging.commit``."""

import ast
import dataclasses
import importlib
import inspect
import logging
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import bevy_ggrs_tpu_torch as T
from bevy_ggrs_tpu.models import fixed_point as j_fixed_point
from bevy_ggrs_tpu.models import pong as j_pong
from bevy_ggrs_tpu.models import stress_soa as j_stress_soa
from bevy_ggrs_tpu.ops import make_advance_fn as j_make_advance_fn
from bevy_ggrs_tpu_torch import ops as t_ops
from bevy_ggrs_tpu_torch.convert import world_from_numpy, world_to_numpy
from bevy_ggrs_tpu_torch.models import box_game as t_box_game
from bevy_ggrs_tpu_torch.models import fixed_point as t_fixed_point
from bevy_ggrs_tpu_torch.models import pong as t_pong
from bevy_ggrs_tpu_torch.models import stress_soa as t_stress_soa
from bevy_ggrs_tpu_torch.snapshot import lazy as t_lazy
from bevy_ggrs_tpu_torch.snapshot.checksum import checksum_peek, world_checksums
from bevy_ggrs_tpu_torch.utils import staging, tracing

ROOT = Path(__file__).resolve().parents[1]
JAX_PKG, PORT_PKG = ROOT / "bevy_ggrs_tpu", ROOT / "bevy_ggrs_tpu_torch"
PACKAGES = ["", "ops", "utils", "snapshot", "session", "telemetry", "fleet", "parallel"]
FLOAT_ATOL = 1e-4  # FMA contraction in XLA's CPU code, absent in torch eager

_XLA_ONLY = {
    "unroll": "lax.scan's unroll factor: eager torch runs the frame loop in Python "
              "and has no scan to unroll",
    "fused_checksums": "where XLA places the checksum inside the jitted program; the "
                       "port always folds the stacked output once per call",
    "donate": "XLA buffer donation (donate_argnums); eager torch allocates every "
              "output fresh, so the canonical and padded programs have nothing to donate",
    "donate_outputs": "XLA donation of a wave's outputs for reuse; eager torch has "
                      "no buffer to hand back",
    "recycle_outputs": "the executor's XLA output recycling through donation; "
                       "eager torch has no buffer to hand back",
    "sharding": "a jax.sharding.Sharding; the port's commit takes a torch device",
    "watch_jax": "hooks JAX's compilation log; the port has no JAX compiler to watch",
}
_XLA_PARAMS = {
    "ops/resim.py:resim": ("unroll", "fused_checksums"),
    "ops/resim.py:resim_padded": ("unroll", "fused_checksums"),
    "ops/resim.py:make_canonical_resim_fn": ("donate",),
    "ops/batch.py:make_batched_padded_fn": ("donate", "unroll", "fused_checksums"),
    "ops/batch.py:make_batched_exact_fn": ("unroll", "fused_checksums", "donate_outputs"),
    "ops/batch.py:make_batched_packed_padded_fn": ("unroll", "fused_checksums"),
    "ops/batch.py:make_batched_packed_exact_fn": ("unroll", "fused_checksums",
                                                  "donate_outputs"),
    "ops/batch.py:BucketedWaveExecutor.__init__": ("unroll", "fused_checksums",
                                                   "recycle_outputs"),
    "ops/batch.py:make_sharded_padded_fn": ("unroll", "fused_checksums"),
    "ops/batch.py:make_sharded_exact_fn": ("unroll", "fused_checksums"),
    "ops/batch.py:make_sharded_packed_padded_fn": ("unroll", "fused_checksums"),
    "ops/batch.py:make_sharded_packed_exact_fn": ("unroll", "fused_checksums"),
    "ops/batch.py:ShardedWaveExecutor.__init__": ("unroll", "fused_checksums"),
    "ops/megastep.py:make_megastep_fn": ("unroll", "fused_checksums"),
    "utils/staging.py:commit": ("sharding",),
    "utils/compile_guard.py:CompileGuard.arm": ("watch_jax",),
}
_TREE_SLICE = ("slices a JAX pytree with jax.tree.map; the port's tree helpers "
               "(utils/tree.py) and select_branch / slice_frame take its place")
ALLOWLIST = {
    **{f"{where}({p})": _XLA_ONLY[p] for where, ps in _XLA_PARAMS.items() for p in ps},
    "ops/speculation.py:jax_tree_slice": _TREE_SLICE,
    "ops/speculation.py:jax_tree_slice_range": _TREE_SLICE,
}


def _init_names(path: Path) -> set:
    """Public names an ``__init__.py`` binds: imports, assignments, defs."""
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.ImportFrom):
            names |= {a.asname or a.name for a in node.names}
        elif isinstance(node, ast.Assign):
            names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
    return {n for n in names if not n.startswith("_") or n == "__version__"} - {"annotations"}


def _params(fn: ast.FunctionDef) -> list:
    a = fn.args
    return [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs
            if x.arg not in ("self", "cls")]


def _module_defs(path: Path) -> dict:
    """``qualname -> parameter names`` of the module's public functions,
    classes (their ``__init__``) and class methods."""
    out = {}
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.FunctionDef) and not node.name.startswith("_"):
            out[node.name] = _params(node)
        elif isinstance(node, ast.ClassDef) and not node.name.startswith("_"):
            out[node.name] = None
            for sub in node.body:
                if isinstance(sub, ast.FunctionDef) and (
                        not sub.name.startswith("_") or sub.name == "__init__"):
                    out[f"{node.name}.{sub.name}"] = _params(sub)
    return out


def _shared_modules() -> list:
    return sorted(p.relative_to(JAX_PKG).as_posix() for p in JAX_PKG.rglob("*.py")
                  if (PORT_PKG / p.relative_to(JAX_PKG)).exists())


def _surface_differences() -> set:
    """Every JAX name, method or parameter the port's same module lacks."""
    missing = set()
    for rel in _shared_modules():
        dotted = rel[:-3].replace("/", ".").removesuffix("__init__").rstrip(".")
        mod = importlib.import_module("bevy_ggrs_tpu_torch" + (f".{dotted}" if dotted else ""))
        for qual, params in _module_defs(JAX_PKG / rel).items():
            obj = mod
            try:
                for part in qual.split("."):
                    obj = getattr(obj, part)
            except AttributeError:
                missing.add(f"{rel}:{qual}")
                continue
            if params is None:
                continue
            try:
                have = inspect.signature(obj).parameters
            except (TypeError, ValueError):
                continue
            if any(p.kind is p.VAR_KEYWORD for p in have.values()):
                continue
            missing |= {f"{rel}:{qual}({p})" for p in params if p not in have}
    return missing


@pytest.mark.parametrize("package", PACKAGES, ids=lambda p: p or "top")
def test_init_names_are_the_jax_packages(package):
    jax_mod = importlib.import_module("bevy_ggrs_tpu" + (f".{package}" if package else ""))
    port = importlib.import_module("bevy_ggrs_tpu_torch" + (f".{package}" if package else ""))
    names = _init_names(JAX_PKG / package / "__init__.py")
    assert names
    missing = sorted(n for n in names if not hasattr(port, n))
    assert missing == [], missing
    for n in names:  # a function stays callable, a constant keeps its value
        want, got = getattr(jax_mod, n), getattr(port, n)
        if isinstance(want, (int, str)):
            assert got == want, n
        elif callable(want):
            assert callable(got), n


def test_module_definitions_match_but_the_allowlist():
    missing = _surface_differences()
    assert missing - set(ALLOWLIST) == set(), sorted(missing - set(ALLOWLIST))
    stale = set(ALLOWLIST) - missing
    assert stale == set(), f"allowlisted but not a difference: {sorted(stale)}"
    assert all(ALLOWLIST.values())


def test_ops_resim_is_the_module_and_calls_the_function():
    mod = importlib.import_module("bevy_ggrs_tpu_torch.ops.resim")
    assert t_ops.resim is mod and hasattr(t_ops.resim, "resim_lanes")
    app = t_fixed_point.make_app(device="cpu")
    inputs, status = _script(3)
    got = t_ops.resim(app.reg, app.step, app.init_state(), inputs, status, 0, 16, app.fps)
    want = mod.resim(app.reg, app.step, app.init_state(), inputs, status, 0, 16, app.fps)
    assert torch.equal(got[2], want[2])
    assert set(t_ops.__all__) == _init_names(JAX_PKG / "ops" / "__init__.py")


# -- behaviour ------------------------------------------------------------------


def _script(k: int, players: int = 2, seed: int = 7):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 16, (k, players)).astype(np.uint8),
            np.zeros((k, players), np.int8))


def _jax_leaves(w) -> dict:
    return {f.name: jax.tree.map(np.asarray, getattr(w, f.name))
            for f in dataclasses.fields(w)}


def _j_int(cs) -> int:
    hi, lo = np.asarray(cs).astype(np.uint64)
    return (int(hi) << 32) | int(lo)


def _assert_like_jax(port_world, jax_world, atol: float) -> None:
    """Integers and masks exact, floats within ``atol`` (exact at 0)."""
    got, want = world_to_numpy(port_world), _jax_leaves(jax_world)
    for field in ("comps", "res", "has", "res_present"):
        for n in want[field]:
            a, b = np.asarray(got[field][n]), np.asarray(want[field][n])
            assert a.dtype == b.dtype and a.shape == b.shape, (field, n)
            if a.dtype.kind == "f" and atol:
                np.testing.assert_allclose(a, b, rtol=0, atol=atol, err_msg=n)
            else:
                assert np.array_equal(a, b), (field, n)
    for f in ("alive", "rollback_id", "despawn_pending", "despawn_frame", "next_id"):
        assert np.array_equal(got[f], want[f]), f


@pytest.mark.parametrize("model", ["fixed_point", "stress_soa"])
def test_make_advance_fn_matches_jax(model):
    if model == "fixed_point":
        japp, tapp, atol = j_fixed_point.make_app(), t_fixed_point.make_app(device="cpu"), 0.0
    else:
        japp = j_stress_soa.make_app(n_entities=512)
        tapp = t_stress_soa.make_app(n_entities=512, device="cpu")
        atol = FLOAT_ATOL
    jfn = j_make_advance_fn(japp.reg, japp.step, japp.fps)
    tfn = t_ops.make_advance_fn(tapp.reg, tapp.step, tapp.fps)
    inputs, status = _script(8, seed=11)
    jw, tw = japp.init_state(), tapp.init_state()
    start = 2**31 - 4  # the clock wraps inside the run
    for i in range(8):
        frame = (start + i + 1 + 2**31) % 2**32 - 2**31
        jw, jcs = jfn(jw, inputs[i], status[i], frame)
        tw, tcs = tfn(tw, torch.from_numpy(inputs[i]), torch.from_numpy(status[i]), frame)
        _assert_like_jax(tw, jw, atol)
        # the checksum is exact on identical bits
        carried = world_from_numpy(tapp.reg, _jax_leaves(jw), "cpu")
        assert T.checksum_to_int(T.world_checksum(tapp.reg, carried)) == _j_int(jcs)
        if atol == 0.0:
            assert T.checksum_to_int(tcs) == _j_int(jcs)


def test_make_advance_fn_frames_equal_resim_fn():
    app = t_stress_soa.make_app(n_entities=256, device="cpu")
    fn = T.ops.make_advance_fn(app.reg, app.step, T.DEFAULT_FPS)
    inputs, status = _script(8, seed=3)
    _, stacked, checks = app.resim_fn(app.init_state(), inputs, status, 10)
    w = app.init_state()
    for i in range(8):
        w, cs = fn(w, inputs[i], status[i], 11 + i)
        assert torch.equal(cs, checks[i])
        for n, col in w.comps.items():
            assert torch.equal(col, stacked.comps[n][i]), n


def test_pong_module_step_matches_jax_rally():
    frames = 200
    japp = j_pong.make_app()
    closure = t_pong.make_app(device="cpu")  # the app's own step, same game
    tapp = t_pong.make_app(device="cpu")  # the last make_app: pong.step's registry
    assert t_pong._REG[0] is tapp.reg
    tapp.set_step(t_pong.step)
    rng = np.random.default_rng(5)
    inputs = np.stack([rng.integers(0, 4, frames), np.full(frames, t_pong.UP)],
                      axis=1).astype(np.uint8)
    status = np.zeros((frames, 2), np.int8)
    jfinal, jstacked, jchecks = japp.resim_fn(japp.init_state(), inputs, status, 0)
    tfinal, tstacked, tchecks = tapp.resim_fn(tapp.init_state(), inputs, status, 0)
    _, _, cchecks = closure.resim_fn(closure.init_state(), inputs, status, 0)
    assert torch.equal(tchecks, cchecks)
    _assert_like_jax(tfinal, jfinal, FLOAT_ATOL)
    assert int(tfinal.res["score"].sum()) >= 1  # the rally had a goal and a re-serve
    carried = world_from_numpy(tapp.reg, _jax_leaves(jstacked), "cpu")
    got = [T.checksum_to_int(c) for c in world_checksums(tapp.reg, carried)]
    assert got == [_j_int(c) for c in np.asarray(jchecks)]


def test_set_tracing_off_gives_the_null_context_with_a_sink():
    seen = []
    tracing.set_span_sink(lambda name, t0, t1: seen.append(name))
    try:
        with tracing.span("on"):
            pass
        tracing.set_tracing(False)
        assert tracing.span("off") is tracing._NULL
        with tracing.span("off"):
            pass
    finally:
        tracing.set_tracing(True)
        tracing.set_span_sink(None)
    assert seen == ["on"]


def test_trace_log_and_the_deprecated_shims(caplog):
    with caplog.at_level(logging.DEBUG, logger="bevy_ggrs_tpu_torch"):
        T.utils.trace_log("resim %d frames", 8)
    assert [(r.name, r.levelno, r.getMessage()) for r in caplog.records] == [
        ("bevy_ggrs_tpu_torch", logging.DEBUG, "resim 8 frames")]
    assert T.utils.get_trace_events() == []
    assert tracing.clear_trace_events() is None


def _synctest_runner(**kw):
    app = t_box_game.make_app(device="cpu")
    session = (T.SessionBuilder.for_app(app).with_check_distance(2)
               .start_synctest_session())
    return T.GgrsRunner(app, session, read_inputs=lambda hs: {h: np.uint8(h + 1) for h in hs},
                        **kw)


def test_runner_profile_writes_one_trace(tmp_path):
    runner = _synctest_runner()
    with runner.profile(tmp_path) as r:
        assert r is runner
        for _ in range(4):
            r.tick()
    traces = list(tmp_path.glob("*.pt.trace.json"))
    assert len(traces) == 1 and traces[0].stat().st_size > 0
    assert runner.frame == 4


def test_checksum_peek_equals_checksum_to_int():
    app = t_fixed_point.make_app(device="cpu")
    cs = T.world_checksum(app.reg, app.init_state())
    assert checksum_peek(cs) == T.checksum_to_int(cs)
    ref = t_lazy.wrap_single_checksum(cs)
    assert checksum_peek(ref) == T.checksum_to_int(ref) == T.checksum_to_int(cs)
    assert torch.equal(ref.device(), cs)


def test_readback_stats_count_each_read_once():
    T.telemetry.reset()
    T.telemetry.enable()
    try:
        before = t_lazy.readback_stats()
        runner = _synctest_runner(pipeline=False)
        for _ in range(6):
            runner.tick()
        runner.finish()
        mid = t_lazy.readback_stats()
        assert mid["harvested"] - before["harvested"] == runner.readbacks.harvested
        assert mid["forced"] - before["forced"] == runner.readbacks.forced > 0
        derived = T.telemetry.summary()["derived"]
        assert derived["readback_harvested_total"] == mid["harvested"] - before["harvested"]
        assert derived["readback_forced_total"] == mid["forced"] - before["forced"]
        cs = T.world_checksum(runner.app.reg, runner.world)
        forced = t_lazy.BatchChecks(cs[None]).ref(0)
        assert forced.to_int() == T.checksum_to_int(cs)  # never started: forced
        harvested = t_lazy.BatchChecks(cs[None])
        harvested.start_async()
        assert harvested.ref(0).peek() == T.checksum_to_int(cs)  # landed: harvested
        after = t_lazy.readback_stats()
        assert (after["forced"] - mid["forced"], after["harvested"] - mid["harvested"]) == (1, 1)
        assert after["blocked_seconds"] >= mid["blocked_seconds"]
    finally:
        T.telemetry.disable()
        T.telemetry.reset()


def test_staging_commit_returns_an_equal_tensor():
    buf = np.arange(24, dtype=np.int32).reshape(4, 6)
    got = staging.commit(buf, "cpu")
    assert got.device.type == "cpu" and torch.equal(got, torch.from_numpy(buf))
    buf[:] = -1  # the host may rewrite the buffer: the upload landed
    assert int(got.sum()) == sum(range(24))
    host = torch.ones(3, dtype=torch.float32)
    assert torch.equal(staging.commit(host, "cpu"), host)
    staging.set_sanitize(True)
    try:
        staging.commit(buf, "cpu")
        assert staging.sanitizer().violations == 0
    finally:
        staging.set_sanitize(False)


def test_staging_commit_needs_a_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        staging.commit(np.zeros(2, np.int8))
