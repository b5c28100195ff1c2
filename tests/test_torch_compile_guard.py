"""The steady-state recompile sentinel on the port
(``bevy_ggrs_tpu_torch/utils/compile_guard.py``).

Mirrors of ``tests/test_compile_guard.py``'s guard cases: armed "compiles"
raise :class:`RecompileError` naming owner and kind and count into
``recompiles_steady_total``; disabled and disarmed guards are no-ops; both
runners' ``arm_compile_guard`` delegate to the guard.  In eager torch a
compile is the first dispatch of a program variant, so the runner's and
the wave executor's seams are driven for real: a SyncTest runner armed
after its first tick trips on the first rollback depth it had not run,
one armed after warm-up runs on clean, and the executor trips on a bucket
first seen after arming.  The JAX package's ``watch_jax`` listener and the
BGT07x lint end-to-end cases have no counterpart here (ROADMAP queue C)."""

import numpy as np
import pytest

from bevy_ggrs_tpu.utils import compile_guard as jguard
from bevy_ggrs_tpu_torch import BatchedRunner, GgrsRunner, SessionBuilder, telemetry
from bevy_ggrs_tpu_torch.models import fixed_point, stress
from bevy_ggrs_tpu_torch.ops import batch as TB
from bevy_ggrs_tpu_torch.utils import compile_guard
from bevy_ggrs_tpu_torch.utils.compile_guard import (
    CompileGuard,
    RecompileError,
    set_compile_guard,
)


@pytest.fixture(autouse=True)
def _guard_off_after():
    yield
    set_compile_guard(False)
    telemetry.disable()
    telemetry.reset()


def test_env_var_enables_the_guard(monkeypatch):
    monkeypatch.setenv("BGT_COMPILE_GUARD", "1")
    assert CompileGuard().enabled
    monkeypatch.setenv("BGT_COMPILE_GUARD", "false")
    assert not CompileGuard().enabled
    monkeypatch.delenv("BGT_COMPILE_GUARD")
    assert not CompileGuard().enabled


def test_disabled_guard_never_arms_and_notify_is_a_noop():
    g = set_compile_guard(False)
    assert g.arm() is False and not g.armed
    compile_guard.notify("solo", "plain:d4", 12.0)  # must not raise
    assert g.steady_compiles == []


def test_enabled_but_disarmed_guard_passes_warmup_compiles():
    set_compile_guard(True)
    compile_guard.notify("batched", "exact:k8", 40.0)  # warmup: no raise
    assert compile_guard.guard().steady_compiles == []


def test_armed_guard_trips_with_owner_kind_and_counter():
    telemetry.enable()
    g = set_compile_guard(True)
    assert g.arm() is True
    with pytest.raises(RecompileError) as ei:
        compile_guard.notify("batched", "padded:k8", 12.5)
    assert ei.value.owner == "batched" and ei.value.kind == "padded:k8"
    assert "BGT070" in str(ei.value) and "BGT071" in str(ei.value)
    assert g.steady_compiles == [("batched", "padded:k8", 12.5)]
    c = telemetry.registry().counter("recompiles_steady_total", "")
    assert c.value(owner="batched") == 1
    # the method and the module-level hook take the same path
    with pytest.raises(RecompileError):
        g.notify("solo", "plain", 1.0)
    assert c.value(owner="solo") == 1


def test_disarm_returns_to_warmup_behavior():
    g = set_compile_guard(True)
    g.arm()
    g.disarm()
    compile_guard.notify("solo", "branched:d2", 1.0)
    assert g.steady_compiles == []


def test_runner_arm_methods_delegate_to_the_guard():
    """Both runners expose arm_compile_guard(); False while the guard is
    disabled, True once enabled.  The methods touch no runner state."""
    set_compile_guard(False)
    for cls in (GgrsRunner, BatchedRunner):
        assert object.__new__(cls).arm_compile_guard() is False
    set_compile_guard(True)
    for cls in (GgrsRunner, BatchedRunner):
        assert object.__new__(cls).arm_compile_guard() is True
        compile_guard.guard().disarm()


def test_the_guard_keeps_the_jax_packages_contract():
    """The same messages, counter and env var as the JAX guard."""
    assert compile_guard._ENV == jguard._ENV and compile_guard._HELP == jguard._HELP
    assert issubclass(RecompileError, RuntimeError)
    e, je = RecompileError("solo", "plain", 3.0), jguard.RecompileError("solo", "plain", 3.0)
    assert (e.owner, e.kind, e.ms) == (je.owner, je.kind, je.ms)
    assert str(e).startswith(str(je).split(" — ")[0])


def _synctest_runner(check_distance=3):
    app = fixed_point.make_app(device="cpu")
    session = (SessionBuilder.for_app(app).with_check_distance(check_distance)
               .start_synctest_session())
    holder = []

    def read_inputs(handles):
        phase = (holder[0].frame // 5) % 4
        return {h: np.uint8(1 << ((phase + h) % 4)) for h in handles}

    runner = GgrsRunner(app, session, read_inputs=read_inputs)
    holder.append(runner)
    return runner


def test_synctest_runner_trips_on_a_depth_first_seen_after_arming():
    telemetry.enable()
    g = set_compile_guard(True)
    runner = _synctest_runner()
    runner.tick()  # warm-up: the one-frame advance only
    seen = set(runner.compile_ms)
    assert runner.arm_compile_guard() is True
    with pytest.raises(RecompileError) as ei:
        for _ in range(10):
            runner.tick()
    assert ei.value.owner == "solo"
    assert len(g.steady_compiles) == 1
    # the variant it names is one the warm-up had not run
    new = set(runner.compile_ms) - seen
    assert len(new) == 1 and next(iter(new)).startswith(ei.value.kind)
    c = telemetry.registry().counter("recompiles_steady_total", "")
    assert c.value(owner="solo") == 1


def test_warmed_synctest_runner_runs_clean_when_armed():
    g = set_compile_guard(True)
    runner = _synctest_runner()
    for _ in range(12):
        runner.tick()
    variants = dict(runner.compile_ms)
    assert runner.arm_compile_guard() is True
    for _ in range(30):
        runner.tick()
    runner.finish()
    assert g.steady_compiles == [] and runner.compile_ms == variants


def test_wave_executor_trips_on_a_bucket_first_seen_after_arming():
    g = set_compile_guard(True)
    m, k = 3, 5
    app = stress.make_app(32, capacity=32, device="cpu")
    worlds = TB.stack_worlds([app.init_state() for _ in range(m)])
    ex = TB.BucketedWaveExecutor(app, k)
    inputs = np.zeros((m, k, 2), np.uint8)
    status = np.zeros((m, k, 2), np.int8)
    starts = np.zeros((m,), np.int32)
    ex.run_wave(worlds, inputs, status, starts, [1, 1, 1])  # the exact program
    ex.run_wave(worlds, inputs, status, starts, [1, 0, 1])  # the ragged one
    assert g.arm() is True
    ex.run_wave(worlds, inputs, status, starts, [1, 1, 1])  # both seen: clean
    ex.run_wave(worlds, inputs, status, starts, [0, 1, 1])
    with pytest.raises(RecompileError) as ei:
        ex.run_wave(worlds, inputs, status, starts, [3, 0, 1])  # bucket 4: new
    assert (ei.value.owner, ei.value.kind) == ("wave", "padded")
    assert [c[:2] for c in g.steady_compiles] == [("wave", "padded")]
