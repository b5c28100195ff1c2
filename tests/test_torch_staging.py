"""The port's pinned staging and its transfer-race sanitizer
(``utils/staging.py``), on the CPU.

Mirrors tests/test_sanitizer.py: a seeded rewrite of a committed staging
buffer before its acquire raises ``TransferRaceError`` only with the
sanitizer armed, the legitimate protocols (acquire-then-rewrite on one
buffer, the depth-2 rotation, rebinding a donated world) stay quiet,
violations are counted per rule, and a real session of the pipelined,
packed, donating runner runs violation-free.  On the CPU there is no
event: an upload lands at once, and the stamps are what is checked."""

import numpy as np
import pytest
import torch

from bevy_ggrs_tpu.utils import staging as j_staging
from bevy_ggrs_tpu_torch import GgrsRunner, SyncTestSession
from bevy_ggrs_tpu_torch.models import box_game, stress
from bevy_ggrs_tpu_torch.ops.packing import pack_prefix
from bevy_ggrs_tpu_torch.session.events import InputStatus
from bevy_ggrs_tpu_torch.utils import staging
from bevy_ggrs_tpu_torch.utils.staging import (
    StagingBuffer,
    StagingQueue,
    TransferRaceError,
    TransferSanitizer,
)


@pytest.fixture(autouse=True)
def _sanitizer_off_after():
    yield
    staging.set_sanitize(False)


def mk():
    return np.zeros((4, 32), dtype=np.int8)


def test_seeded_staging_reuse_race_caught_only_when_armed():
    staging.set_sanitize(True)
    q = StagingQueue(mk, depth=2, device="cpu")
    buf = q.acquire()
    pack_prefix(buf, 0, 3)
    q.commit(buf[:3])
    with pytest.raises(TransferRaceError, match="in flight"):
        pack_prefix(buf, 1, 3)

    # disarmed (the default): the same seeded race passes silently
    staging.set_sanitize(False)
    q2 = StagingQueue(mk, depth=2, device="cpu")
    b2 = q2.acquire()
    pack_prefix(b2, 0, 3)
    q2.commit(b2[:3])
    pack_prefix(b2, 1, 3)  # no raise: this is the silent corruption


def test_rotation_protocol_never_trips_the_sanitizer():
    staging.set_sanitize(True)
    q = StagingQueue(mk, depth=2, device="cpu")
    for tick in range(8):
        buf = q.acquire()
        pack_prefix(buf, tick, 2)
        out = q.commit(buf[:3])
        assert int(out[0, :4].view(torch.int32)[0]) == tick
    assert q.landed_free == 6 and q.deferred_blocks == 0


def test_acquire_after_commit_allows_the_rewrite():
    """The port's analog of the JAX package's synchronous commit: one
    buffer, reused once its upload has landed (its acquire)."""
    staging.set_sanitize(True)
    stage = StagingBuffer(mk, "cpu")
    buf = stage.acquire()
    pack_prefix(buf, 5, 1)
    x = stage.commit(buf)
    assert np.array_equal(x.numpy(), buf)
    assert stage.acquire() is buf  # the upload landed: stamp cleared
    pack_prefix(buf, 6, 1)
    assert int(x[0, :4].view(torch.int32)[0]) == 5  # the upload kept its bytes


def test_queue_needs_two_buffers_and_cpu_commits_copy():
    with pytest.raises(ValueError, match="depth >= 2"):
        StagingQueue(mk, depth=1, device="cpu")
    stage = StagingBuffer(mk, "cpu")
    buf = stage.acquire()
    x = stage.commit(buf[:2])
    buf[:] = 1
    assert int(x.abs().sum()) == 0  # a CPU commit is a copy, not a view


def test_donation_guard_and_rebind():
    san = staging.set_sanitize(True)
    a, b = mk(), mk()
    san.guard_donated(a, "test")  # never donated: fine
    san.donate(a, "wave 0")
    with pytest.raises(TransferRaceError, match="donated"):
        san.guard_donated(a, "test")
    san.undonate(a)  # slot rebound from the call result
    san.guard_donated(a, "test")
    san.guard_donated(b, "test")


def test_donated_table_is_bounded():
    san = staging.set_sanitize(True)
    arrs = [np.zeros(1, np.int8) for _ in range(TransferSanitizer._DONATED_CAP + 8)]
    for i, a in enumerate(arrs):
        san.donate(a, f"wave {i}")
    assert len(san._donated) == TransferSanitizer._DONATED_CAP
    assert TransferSanitizer._DONATED_CAP == j_staging.TransferSanitizer._DONATED_CAP
    san.guard_donated(arrs[0], "test")  # oldest entries aged out
    with pytest.raises(TransferRaceError):
        san.guard_donated(arrs[-1], "test")


def test_violations_counted_per_rule():
    san = staging.set_sanitize(True)
    buf = mk()
    san.begin(buf, "test upload")
    with pytest.raises(TransferRaceError):
        san.guard_write(buf, "test rewrite")
    san.donate(buf)
    with pytest.raises(TransferRaceError):
        san.guard_donated(buf, "test redispatch")
    assert san.violations == 2
    assert san.violations_by_rule == {"staging_reuse": 1, "donated_reuse": 1}


def test_env_var_arms_the_default_sanitizer(monkeypatch):
    monkeypatch.setenv("BGT_SANITIZE", "1")
    assert TransferSanitizer().enabled
    monkeypatch.delenv("BGT_SANITIZE")
    assert not TransferSanitizer().enabled


def test_disabled_hooks_are_noops():
    san = TransferSanitizer(enabled=False)
    buf = mk()
    san.begin(buf)
    san.guard_write(buf)
    san.donate(buf)
    san.guard_donated(buf)
    san.undonate(buf)
    assert san.violations == 0 and san._inflight == {} and san._donated == {}


def test_redispatching_a_donated_world_raises_when_armed():
    staging.set_sanitize(True)
    app = stress.make_app(32, device="cpu")
    inputs = np.zeros((2, 2), np.uint8)
    status = np.full((2, 2), InputStatus.CONFIRMED, np.int8)
    world = app.init_state()
    final, _, _ = app.resim_fn_donated(world, inputs, status, 0)
    final, _, _ = app.resim_fn(final, inputs, status, 2)  # the returned world: fine
    with pytest.raises(TransferRaceError, match="donated"):
        app.resim_fn(world, inputs, status, 0)


@pytest.mark.parametrize("kw", [{}, {"input_queue": True}, {"packed": False}],
                         ids=["packed", "input_queue", "unpacked"])
def test_real_session_runs_violation_free(kw):
    san = staging.set_sanitize(True)
    app = box_game.make_app(device="cpu")
    rng = np.random.default_rng(3)
    runner = GgrsRunner(app, SyncTestSession(num_players=2, check_distance=4),
                        read_inputs=lambda hs: {h: np.uint8(rng.integers(0, 16))
                                                for h in hs},
                        on_mismatch=lambda e: (_ for _ in ()).throw(e), **kw)
    for _ in range(30):
        runner.tick()
    runner.finish()
    assert san.violations == 0
    assert runner.stats()["donated_dispatches"] > 0
    assert len(san._donated) > 0  # the donations were recorded, and never reused
