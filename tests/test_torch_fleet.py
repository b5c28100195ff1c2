"""The fleet on the port (``bevy_ggrs_tpu_torch/fleet``), held against the
JAX package's fleet, on the CPU.

- The wire: every message's bytes equal the JAX package's, and each
  package decodes the other's; checkpoint chunking byte for byte; mirrors
  of ``tests/test_fleet.py``'s protocol and ``ChunkAssembler`` cases.
- The lobby: ``synthetic_inputs``, ``schema_digest`` and ``spec_est_bytes``
  equal the JAX package's; a port and a JAX ``LobbySim`` after 90 frames
  hold the same states (``atol=1e-4, rtol=0``: XLA contracts FMAs, ROADMAP
  queue C); a JAX lobby's checkpoint restores in the port with the JAX
  checksum at that frame, and a port checkpoint in the JAX package; the
  port's restore at an unaligned frame equals its straight run bit for bit
  (the migration invariant), the external-input tail rides the checkpoint.
- The control loop over loopback UDP: live migration, admission reject on
  the wire, failover from the last confirmed checkpoint, byte/slot-aware
  placement, malformed datagrams counted; a port worker under a JAX
  scheduler and a JAX worker under a port scheduler each finish a lobby on
  their own package's control checksum.
- The CLIs: ``scripts/torch_fleet_scheduler.py`` and
  ``scripts/torch_fleet_worker.py`` as subprocesses under
  ``BGT_PLATFORM=cpu`` finish one 32-entity lobby; ``torch_replay_tool.py``
  reads a recording and merges two peers' desync reports.
- Checkpoint bursts past a receiver's socket buffer: rotated re-ship rounds
  complete them where the reference's one order never does (ROADMAP
  queue C), and a lobby with a ~13-chunk checkpoint migrates at the
  kernel's default buffer.

Each loop's timeouts are no longer than its JAX twin's."""

import dataclasses
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from bevy_ggrs_tpu import telemetry as jtel
from bevy_ggrs_tpu import fleet as JF
from bevy_ggrs_tpu.fleet import protocol as JP
from bevy_ggrs_tpu.snapshot import persist as jper
from bevy_ggrs_tpu_torch import telemetry
from bevy_ggrs_tpu_torch import fleet as TF
from bevy_ggrs_tpu_torch.fleet import (
    ChunkAssembler,
    FleetClient,
    FleetScheduler,
    FleetWorker,
    LobbySim,
    LobbySpec,
    checksum_hex,
    chunk_checkpoint,
    decode,
)
from bevy_ggrs_tpu_torch.fleet import protocol as P
from bevy_ggrs_tpu_torch.snapshot import persist as tper

ROOT = Path(__file__).resolve().parent.parent
SMALL = dict(app="stress_soa", entities=32, seed=9)
CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the loops run on wall-clock timeouts; intra-op threads spinning
    # against the other test workers slowed a 16,384-entity chunk 20x
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# -- the wire, against the JAX package --------------------------------------

def _messages(M):
    """Every fleet message of protocol module ``M``, by name."""
    return {
        "register": M.encode_register("w0", 7),
        "heartbeat": M.encode_heartbeat("w0", {"capacity": 2, "lobbies": {
            "l0": {"frame": 3, "state": "running"}}, "lobby_qos_score": {"l0": 97.5}}),
        "heartbeat_seq": M.encode_heartbeat_seq("w0", 77, "ab12cd34ef56ab78"),
        "place": M.encode_place("l0", {"app": "stress_soa", "entities": 32}),
        "place_ok": M.encode_place_ok("l0", 42),
        "drain": M.encode_drain("l0", 2**32 + 99),  # wraps to u32 in both
        "ckpt": M.encode_ckpt_chunk("l0", 10, 3, 5, bytes(range(200))),
        "ckpt_ack": M.encode_ckpt_ack("l0", 10),
        "resume": M.encode_resume("l0", 10, {"seed": 1}),
        "resume_ok": M.encode_resume_ok("l0", 10),
        "drop": M.encode_drop("lobby-é"),
        "submit": M.encode_submit("l0", {"entities": 3}),
        "submit_ok": M.encode_submit_ok("l0", "w1"),
        "reject": M.encode_reject("l0", "capacity"),
        "done": M.encode_done("l0", 600, "ab" * 8),
    }


@pytest.mark.parametrize("name", sorted(_messages(P)))
def test_every_message_is_the_jax_packages_bytes(name):
    mine, theirs = _messages(P)[name], _messages(JP)[name]
    assert mine == theirs
    # each package decodes the other's datagram to the same fields
    assert dataclasses.astuple(decode(theirs)) == dataclasses.astuple(JP.decode(mine))


def test_type_bytes_chunk_size_and_digest_match_the_jax_package():
    names = [n for n in dir(JP) if n.startswith("T_")]
    assert names and {n: getattr(P, n) for n in names} == {n: getattr(JP, n) for n in names}
    assert P.CKPT_CHUNK_BYTES == JP.CKPT_CHUNK_BYTES
    stats = {"lobbies": {"a": {"frame": 1}}, "capacity": 2}
    assert P.stats_digest(stats) == JP.stats_digest(stats)
    blob = bytes(np.random.default_rng(5).integers(0, 256, 100_000, dtype=np.uint8))
    assert chunk_checkpoint("l0", 7, blob) == JP.chunk_checkpoint("l0", 7, blob)


def test_protocol_roundtrips():
    cases = [
        (P.encode_register("w0", 7), P.T_REGISTER,
         lambda m: (m.a, m.total) == ("w0", 7)),
        (P.encode_heartbeat("w0", {"capacity": 2}), P.T_HEARTBEAT,
         lambda m: m.obj == {"capacity": 2}),
        (P.encode_place("l0", {"app": "stress_soa"}), P.T_PLACE,
         lambda m: m.obj["app"] == "stress_soa"),
        (P.encode_place_ok("l0", 42), P.T_PLACE_OK, lambda m: m.frame == 42),
        (P.encode_drain("l0", 99), P.T_DRAIN, lambda m: m.frame == 99),
        (P.encode_ckpt_ack("l0", 10), P.T_CKPT_ACK, lambda m: m.frame == 10),
        (P.encode_resume("l0", 10, {"seed": 1}), P.T_RESUME,
         lambda m: (m.frame, m.obj) == (10, {"seed": 1})),
        (P.encode_resume_ok("l0", 10), P.T_RESUME_OK, lambda m: m.frame == 10),
        (P.encode_drop("l0"), P.T_DROP, lambda m: m.a == "l0"),
        (P.encode_submit("l0", {"entities": 3}), P.T_SUBMIT,
         lambda m: m.obj == {"entities": 3}),
        (P.encode_submit_ok("l0", "w1"), P.T_SUBMIT_OK, lambda m: m.b == "w1"),
        (P.encode_reject("l0", "capacity"), P.T_REJECT,
         lambda m: m.b == "capacity"),
        (P.encode_done("l0", 600, "ab" * 8), P.T_DONE,
         lambda m: (m.frame, m.b) == (600, "ab" * 8)),
    ]
    for data, kind, check in cases:
        msg = decode(data)
        assert msg is not None and msg.kind == kind and msg.a[0] in "wl"
        assert check(msg), kind


def test_protocol_drops_malformed():
    from bevy_ggrs_tpu_torch.session.room import ROOM_MAGIC, _HDR

    assert decode(b"") is None
    assert decode(b"\x00\x01\x02") is None  # wrong magic
    assert decode(_HDR.pack(ROOM_MAGIC, P.T_REGISTER)) is None  # truncated
    assert decode(_HDR.pack(ROOM_MAGIC, 250)) is None  # unknown type
    # a checkpoint chunk whose seq is past its total
    assert decode(P.encode_ckpt_chunk("l0", 1, 5, 5, b"x")) is None


def test_chunk_assembler_out_of_order_and_supersede():
    blob = bytes(range(256)) * 600  # > 4 chunks
    grams = chunk_checkpoint("l0", 5, blob)
    assert len(grams) > 2
    asm = ChunkAssembler()
    msgs = [decode(g) for g in grams]
    for m in msgs[1:]:
        assert asm.offer(m) is None
    assert asm.offer(msgs[0]) == blob
    asm2 = ChunkAssembler()
    asm2.offer(msgs[0])
    newer = [decode(g) for g in chunk_checkpoint("l0", 6, blob)]
    for m in newer[:-1]:
        assert asm2.offer(m) is None
    assert asm2.offer(newer[-1]) == blob
    assert asm2.pending() == []


def test_chunk_assembler_fuzz_reorder_dup_interleave():
    """Random reorder, duplicated chunks, two frames' streams interleaved:
    every completion is bit-exact for the frame whose chunk completed it."""
    rng = np.random.default_rng(1234)
    blobs = {
        5: bytes(rng.integers(0, 256, size=90_000, dtype=np.uint8)),
        6: bytes(rng.integers(0, 256, size=70_000, dtype=np.uint8)),
    }
    msgs = {f: [decode(g) for g in chunk_checkpoint("l0", f, blob)]
            for f, blob in blobs.items()}
    for trial in range(20):
        stream = [m for f in blobs for m in msgs[f]]
        dups = rng.choice(len(stream), size=4, replace=False)
        stream += [stream[i] for i in dups]
        rng.shuffle(stream)
        asm = ChunkAssembler()
        done = set()
        for m in stream:
            out = asm.offer(m)
            if out is not None:
                assert out == blobs[m.frame], trial
                done.add(m.frame)
        assert 6 in done, trial
        assert {k[0] for k in asm.pending()} <= {"l0"}


def test_chunk_assembler_truncated_then_completed():
    blob = bytes(range(256)) * 300
    msgs = [decode(g) for g in chunk_checkpoint("l0", 9, blob)]
    assert len(msgs) >= 3
    asm = ChunkAssembler()
    for m in msgs[:-1]:
        assert asm.offer(m) is None
    assert asm.pending() == [("l0", 9)]
    assert asm.offer(msgs[-1]) == blob
    assert asm.pending() == []


def test_jax_datagrams_reassemble_in_the_port():
    blob = bytes(np.random.default_rng(3).integers(0, 256, 80_000, dtype=np.uint8))
    asm = ChunkAssembler()
    got = [asm.offer(decode(g)) for g in reversed(JP.chunk_checkpoint("l1", 4, blob))]
    assert got[-1] == blob and all(g is None for g in got[:-1])


# -- the lobby ---------------------------------------------------------------

SPECS = {
    "stress_soa_32": dict(app="stress_soa", entities=32, seed=9),
    "stress_soa_4096": dict(app="stress_soa", entities=4096, seed=2),
    "box_game_2": dict(app="box_game", players=2),
    "box_game_4": dict(app="box_game", players=4, seed=5),
}


@pytest.mark.parametrize("name", sorted(SPECS))
def test_inputs_digest_and_sizing_equal_the_jax_package(name):
    kw = SPECS[name]
    tspec, jspec = LobbySpec(lobby_id="l", **kw), JF.LobbySpec(lobby_id="l", **kw)
    assert TF.spec_est_bytes(tspec) == JF.spec_est_bytes(jspec)
    tapp = TF.APP_CATALOG[kw["app"]](tspec, CPU)
    japp = JF.APP_CATALOG[kw["app"]](jspec)
    assert tper.schema_digest(tapp.reg) == jper.schema_digest(japp.reg)
    for frame in (1, 2, 17, 600, 2**31 + 5):
        t, j = TF.synthetic_inputs(tspec, tapp, frame), JF.synthetic_inputs(jspec, japp, frame)
        assert t.dtype == j.dtype and np.array_equal(t, j)
    # the lobby's own world bytes, read from its tensors, equal the sizing
    sim = LobbySim(tspec, device=CPU)
    assert sim.est_bytes() == TF.spec_est_bytes(tspec)
    assert sim.state_digest() == tper.schema_digest(tapp.reg)
    assert TF.spec_est_bytes(dataclasses.replace(tspec, est_bytes=123)) == 123


def _jax_world(world) -> dict:
    return {f.name: jax.tree.map(np.asarray, getattr(world, f.name))
            for f in dataclasses.fields(world)}


def _assert_states_close(jworld, tworld):
    want = _jax_world(jworld)
    for field, jval in want.items():
        tval = getattr(tworld, field)
        jl = jax.tree_util.tree_leaves(jval)
        tl = [tval] if isinstance(tval, torch.Tensor) else None
        if tl is None:
            from bevy_ggrs_tpu_torch.utils.tree import tree_leaves

            tl = tree_leaves(tval)
        assert len(jl) == len(tl), field
        for a, b in zip(jl, tl):
            b = b.numpy()
            if np.issubdtype(a.dtype, np.floating):
                np.testing.assert_allclose(b, a, atol=1e-4, rtol=0, err_msg=field)
            else:
                np.testing.assert_array_equal(b, a, err_msg=field)


@pytest.mark.parametrize("name", ["stress_soa_32", "box_game_2"])
def test_port_lobby_holds_the_jax_lobbys_states(name):
    kw = SPECS[name]
    t = LobbySim(LobbySpec(lobby_id="l", target_frames=90, **kw), device=CPU)
    j = JF.LobbySim(JF.LobbySpec(lobby_id="l", target_frames=90, **kw))
    t.run_to(90)
    j.run_to(90)
    assert t.frame == j.frame == 90 and t.done and j.done
    _assert_states_close(j.world, t.world)


@pytest.mark.parametrize("frame", [37, 48])
def test_jax_checkpoint_restores_in_the_port_and_back(frame):
    spec = dict(lobby_id="l", target_frames=90, **SMALL)
    j = JF.LobbySim(JF.LobbySpec(**spec))
    j.run_to(frame)
    t = LobbySim.restore(LobbySpec(**spec), j.checkpoint_bytes(), device=CPU)
    assert t.frame == frame
    # identical bits: the port's checksum of the JAX world is the JAX one
    assert t.checksum() == j.checksum()
    back = JF.LobbySim.restore(JF.LobbySpec(**spec), t.checkpoint_bytes())
    assert back.frame == frame and back.checksum() == j.checksum()


def test_lobby_checkpoint_restore_bit_equality():
    # the migration invariant: straight run == run split by a checkpoint /
    # restore at an awkward (non-chunk-aligned) frame, bit for bit
    spec = LobbySpec(lobby_id="l0", target_frames=90, **SMALL)
    control = LobbySim(spec, device=CPU)
    control.run_to(90)
    a = LobbySim(spec, device=CPU)
    a.run_to(37)
    b = LobbySim.restore(spec, a.checkpoint_bytes(), device=CPU)
    assert b.frame == 37
    b.run_to(90)
    assert b.checksum() == control.checksum()
    # and chunked otherwise again (7-frame steps) to the same bits
    c = LobbySim.restore(spec, a.checkpoint_bytes(), device=CPU)
    c.run_to(90, chunk=7)
    assert c.checksum() == control.checksum()


def test_lobby_external_input_tail_rides_checkpoint():
    spec = LobbySpec(lobby_id="e0", app="box_game", target_frames=20,
                     input_mode="external")
    sim = LobbySim(spec, device=CPU)
    for f in range(1, 11):
        sim.submit_input(f, np.full(
            (sim.app.num_players, *sim.app.input_shape), f, sim.app.input_dtype))
    sim.step(6)
    assert sim.frame == 6
    restored = LobbySim.restore(spec, sim.checkpoint_bytes(), device=CPU)
    assert restored.frame == 6
    assert sorted(restored.pending) == [7, 8, 9, 10]
    restored.step(20)
    assert restored.frame == 10  # only the shipped tail was simulatable
    sim.step(20)
    assert sim.frame == 10
    assert restored.checksum() == sim.checksum()
    with pytest.raises(ValueError):
        restored.submit_input(3, np.zeros(
            (restored.app.num_players, *restored.app.input_shape),
            restored.app.input_dtype))


def test_lobby_refuses_bad_specs_and_oversized_steps():
    with pytest.raises(ValueError, match="unknown lobby app"):
        LobbySim(LobbySpec(lobby_id="x", app="nope"), device=CPU)
    with pytest.raises(ValueError, match="input_mode"):
        LobbySim(LobbySpec(lobby_id="x", input_mode="psychic"), device=CPU)
    sim = LobbySim(LobbySpec(lobby_id="x", **SMALL), device=CPU)
    with pytest.raises(ValueError, match="canonical_depth"):
        sim.step(TF.LOBBY_CHUNK + 1)
    with pytest.raises(ValueError, match="synthetic"):
        sim.submit_input(1, np.zeros((2,), np.uint8))


def test_lobby_and_worker_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LobbySim(LobbySpec(lobby_id="x", **SMALL))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FleetWorker("w", ("127.0.0.1", 9))
    # the scheduler's admission sizing needs no card
    assert TF.spec_est_bytes(LobbySpec(lobby_id="x", **SMALL)) > 0


def test_platform_env_names_the_device(monkeypatch):
    from bevy_ggrs_tpu_torch.utils.platform import apply_platform_env

    for var in ("BGT_PLATFORM", "JAX_PLATFORMS"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("BGT_CPU_DEVICES", "8")  # meaningless for torch: ignored
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    assert apply_platform_env() == "cpu"
    monkeypatch.setenv("BGT_PLATFORM", "tpu")  # BGT_PLATFORM takes precedence
    with pytest.raises(ValueError, match="tpu"):
        apply_platform_env()
    monkeypatch.setenv("BGT_PLATFORM", "CPU,cuda")
    assert apply_platform_env() == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for named in ("gpu", "cuda", None):  # nothing set: CUDA, and it raises
        if named is None:
            monkeypatch.delenv("BGT_PLATFORM")
            monkeypatch.delenv("JAX_PLATFORMS")
        else:
            monkeypatch.setenv("BGT_PLATFORM", named)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            apply_platform_env()


# -- scheduler / worker over loopback UDP ------------------------------------

def _pump(sched, workers, n=1, sleep=0.002):
    for _ in range(n):
        sched.poll()
        for w in workers:
            w.poll()
        time.sleep(sleep)


def _pump_until(sched, workers, cond, timeout_s=30.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        _pump(sched, workers)
        if cond():
            return True
    return False


@pytest.fixture()
def fleet():
    telemetry.reset()
    telemetry.enable()
    sched = FleetScheduler(worker_timeout_s=30.0)  # no spurious deaths
    workers = [FleetWorker(f"w{i}", sched.local_addr, capacity=2,
                           ckpt_every_frames=25, device=CPU) for i in range(2)]
    for w in workers:
        w.register()
    assert _pump_until(sched, workers, lambda: len(sched.workers) == 2, 10)
    yield sched, workers
    for w in workers:
        w.close()
    sched.close()
    telemetry.disable()
    telemetry.reset()


def _control_hex(spec) -> str:
    control = LobbySim(spec, device=CPU)
    control.run_to(spec.target_frames)
    return checksum_hex(control.checksum())


def test_fleet_live_migration_bit_equality(fleet):
    sched, workers = fleet
    spec = LobbySpec(lobby_id="mig", target_frames=300, **SMALL)
    ok, wid = sched.submit(spec)
    assert ok
    rec = sched.lobbies["mig"]
    assert _pump_until(sched, workers, lambda: rec.state == "running", 10)
    assert sched.migrate("mig")
    assert _pump_until(sched, workers,
                       lambda: rec.state == "running" and rec.worker_id != wid, 30), \
        "migration did not complete"
    assert _pump_until(sched, workers, lambda: rec.state == "done", 30)
    assert rec.final_checksum == _control_hex(spec)
    series = telemetry.summary()["metrics"]["lobby_migrations_total"]["series"]
    assert series.get("outcome=ok") == 1
    assert telemetry.summary()["metrics"].get("migration_downtime_ms") is not None
    ok_events = [e for e in sched.events if e["event"] == "migrate_ok"]
    assert len(ok_events) == 1 and ok_events[0]["frame"] > 0


def test_fleet_admission_reject_is_wire_visible(fleet):
    sched, workers = fleet
    for i in range(4):  # 2 workers x capacity 2
        ok, _ = sched.submit(LobbySpec(lobby_id=f"fill{i}", target_frames=10_000, **SMALL))
        assert ok
    ok, reason = sched.submit(LobbySpec(lobby_id="over", **SMALL))
    assert not ok and reason == "capacity"
    cli = FleetClient(sched.local_addr)
    stop = threading.Event()

    def pumper():
        while not stop.is_set():
            _pump(sched, workers)

    t = threading.Thread(target=pumper)
    t.start()
    try:
        got = cli.submit(LobbySpec(lobby_id="over2", **SMALL), timeout_s=10)
    finally:
        stop.set()
        t.join(timeout=10)
        cli.close()
    assert not t.is_alive()
    assert got is None and cli.last_reject == "capacity"
    series = telemetry.summary()["metrics"]["admission_rejects_total"]["series"]
    assert series.get("reason=capacity", 0) >= 2


def test_fleet_failover_from_confirmed_checkpoint(fleet):
    sched, workers = fleet
    sched.worker_timeout_s = 2.0
    spec = LobbySpec(lobby_id="vic", target_frames=1200, **SMALL)
    ok, _ = sched.submit(spec)
    assert ok
    rec = sched.lobbies["vic"]
    assert _pump_until(sched, workers,
                       lambda: rec.ckpt_blob is not None and rec.state == "running", 20)
    assert rec.frame < 1200
    victim = next(w for w in workers if w.worker_id == rec.worker_id)
    survivor = next(w for w in workers if w is not victim)
    victim.close()
    assert _pump_until(sched, [survivor], lambda: rec.state == "done", 60), \
        f"no failover completion (state={rec.state})"
    assert rec.final_checksum == _control_hex(spec)
    series = telemetry.summary()["metrics"]["lobby_migrations_total"]["series"]
    assert series.get("outcome=failover") == 1
    fo = [e for e in sched.events if e["event"] == "failover"]
    assert len(fo) == 1 and fo[0]["frame"] > 0


def test_scheduler_placement_is_bytes_and_slot_aware():
    telemetry.reset()
    sched = FleetScheduler(worker_timeout_s=30.0, mem_budget_bytes=40 * 1024)
    w = FleetWorker("w0", sched.local_addr, capacity=8, device=CPU)
    w.register()
    try:
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and not sched.workers:
            sched.poll()
            w.poll()
            time.sleep(0.002)
        assert "w0" in sched.workers
        ok, _ = sched.submit(LobbySpec(lobby_id="a", **SMALL))
        assert ok
        big = LobbySpec(lobby_id="b", app="stress_soa", entities=4096, seed=1)
        ok, reason = sched.submit(big)
        assert not ok and reason == "memory"
        assert sched.lobbies["a"].est_bytes == JF.spec_est_bytes(
            JF.LobbySpec(lobby_id="a", **SMALL))
    finally:
        w.close()
        sched.close()


def test_malformed_datagrams_counted_and_logged_once_per_peer(caplog):
    import logging

    telemetry.reset()
    telemetry.enable()
    P._malformed_peers.clear()
    sched = FleetScheduler(worker_timeout_s=30.0)
    w = FleetWorker("w0", sched.local_addr, capacity=1, device=CPU)
    src = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        counter = telemetry.registry().counter("fleet_malformed_datagrams_total", "")
        with caplog.at_level(logging.WARNING, logger="bevy_ggrs_tpu_torch.fleet.protocol"):
            for _ in range(3):
                src.sendto(b"\x00garbage", sched.local_addr)
            deadline = time.monotonic() + 5
            while time.monotonic() < deadline and counter.value() < 3:
                sched.poll()
                time.sleep(0.002)
            assert counter.value() == 3
            src.sendto(b"\xff" * 5, w.local_addr)
            deadline = time.monotonic() + 5
            while time.monotonic() < deadline and counter.value() < 4:
                w.poll()
                time.sleep(0.002)
            assert counter.value() == 4
        warnings = [r for r in caplog.records if "malformed" in r.getMessage()]
        assert len(warnings) == 1, [r.getMessage() for r in warnings]
    finally:
        src.close()
        w.close()
        sched.close()
        telemetry.disable()
        telemetry.reset()
        P._malformed_peers.clear()


# -- checkpoint bursts past the receive buffer ---------------------------------

# half the Linux default receive buffer: the kernel doubles what is asked,
# so the sockets get the 212,992 B a host at its defaults gives them
DEFAULT_RCVBUF_ASK = 212_992 // 2


def _bursts_until_complete(order, rounds=13):
    """Send a 50-chunk checkpoint to a default-buffer socket ``rounds``
    times, draining only between bursts (a receiver busy between polls);
    the round it completed in, or None."""
    blob = bytes(np.random.default_rng(8).integers(0, 256, 50 * P.CKPT_CHUNK_BYTES,
                                                    dtype=np.uint8))
    grams = chunk_checkpoint("big", 120, blob)
    assert len(grams) == 50
    rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    rx.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, DEFAULT_RCVBUF_ASK)
    rx.bind(("127.0.0.1", 0))
    rx.setblocking(False)
    asm = ChunkAssembler()
    try:
        for r in range(rounds):
            for g in order(grams, r):
                tx.sendto(g, rx.getsockname())
            while True:
                try:
                    data, _ = rx.recvfrom(65536)
                except BlockingIOError:
                    break
                if asm.offer(decode(data)) is not None:
                    return r
    finally:
        rx.close()
        tx.close()
    return None


def test_rotated_reship_rounds_complete_a_burst_past_the_receive_buffer():
    # the reference's fixed order lands the same head every round
    assert _bursts_until_complete(lambda grams, r: grams) is None
    done = _bursts_until_complete(P.reship_order)
    assert done is not None and done <= 50 // P.RESHIP_STRIDE


def test_fleet_migrates_a_lobby_past_the_receive_buffer():
    """A 16,384-entity lobby (a ~13-chunk checkpoint) migrates between two
    workers, every socket at the kernel's default receive buffer: the
    rotated re-ship rounds deliver both the drain checkpoint and the RESUME
    burst, and the lobby ends on its control's checksum."""
    telemetry.reset()
    sched = FleetScheduler(worker_timeout_s=30.0)
    workers = [FleetWorker(f"w{i}", sched.local_addr, capacity=1, device=CPU)
               for i in range(2)]
    for endpoint in (sched, *workers):
        endpoint._sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, DEFAULT_RCVBUF_ASK)
    spec = LobbySpec(lobby_id="big", app="stress_soa", entities=16_384, seed=3,
                     target_frames=160)
    rounds = []
    try:
        for w in workers:
            w.register()
        assert _pump_until(sched, workers, lambda: len(sched.workers) == 2, 10)
        ok, src = sched.submit(spec)
        assert ok
        rec = sched.lobbies["big"]
        assert _pump_until(sched, workers, lambda: rec.state == "running", 10)
        assert sched.migrate("big")

        def migrated():
            for w in workers:
                h = w.lobbies.get("big")
                if h is not None and h.shipment is not None:
                    rounds.append(h.shipment.rounds)
            return rec.state == "running" and rec.worker_id != src

        assert _pump_until(sched, workers, migrated, 30)
        assert rec.resume_rounds > 1  # one burst could not carry it
        assert _pump_until(sched, workers, lambda: rec.state == "done", 30)
    finally:
        for w in workers:
            w.close()
        sched.close()
    assert max(rounds) > 1
    assert rec.final_checksum == _control_hex(spec)


# -- across the packages -----------------------------------------------------

@pytest.mark.parametrize("sched_pkg", ["jax", "port"])
def test_a_worker_finishes_a_lobby_under_the_other_packages_scheduler(sched_pkg):
    """A port worker under a JAX scheduler, and a JAX worker under a port
    scheduler: placement, heartbeats, checkpoint shipping and DONE all
    cross, and the lobby ends on its host package's control checksum."""
    jtel.reset()
    telemetry.reset()
    if sched_pkg == "jax":
        sched = JF.FleetScheduler(worker_timeout_s=30.0)
        worker = FleetWorker("tw", sched.local_addr, capacity=2, ckpt_every_frames=25,
                             device=CPU)
        spec = JF.LobbySpec(lobby_id="x", target_frames=120, **SMALL)
        want = _control_hex(LobbySpec(**dataclasses.asdict(spec)))
    else:
        sched = FleetScheduler(worker_timeout_s=30.0)
        worker = JF.FleetWorker("jw", sched.local_addr, capacity=2, ckpt_every_frames=25)
        spec = LobbySpec(lobby_id="x", target_frames=120, **SMALL)
        control = JF.LobbySim(JF.LobbySpec(**dataclasses.asdict(spec)))
        control.run_to(120)
        want = JF.checksum_hex(control.checksum())
    worker.register()
    try:
        assert _pump_until(sched, [worker], lambda: len(sched.workers) == 1, 10)
        ok, wid = sched.submit(spec)
        assert ok and wid == worker.worker_id
        rec = sched.lobbies["x"]
        assert _pump_until(sched, [worker], lambda: rec.state == "done", 30)
        assert rec.final_checksum == want
        assert rec.ckpt_blob is not None and rec.ckpt_frame > 0
        assert sched.workers[worker.worker_id].stats["capacity"] == 2
    finally:
        worker.close()
        sched.close()


# -- the CLIs ------------------------------------------------------------------

def _free_port(kind=socket.SOCK_DGRAM) -> int:
    with socket.socket(socket.AF_INET, kind) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _fleet_json(port: int) -> dict:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/fleet", timeout=5) as r:
        return json.load(r)


def test_cli_scheduler_and_worker_finish_a_lobby_on_the_cpu(tmp_path):
    env = dict(os.environ, BGT_PLATFORM="cpu")
    port, mport = _free_port(), _free_port(socket.SOCK_STREAM)
    trace = tmp_path / "w0.trace.json"
    procs = [
        subprocess.Popen([sys.executable, str(ROOT / "scripts" / "torch_fleet_scheduler.py"),
                          "--host", "127.0.0.1", "--port", str(port), "--metrics-port",
                          str(mport)], env=env, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True),
        subprocess.Popen([sys.executable, str(ROOT / "scripts" / "torch_fleet_worker.py"),
                          "--scheduler", f"127.0.0.1:{port}", "--worker-id", "w0",
                          "--capacity", "1", "--ckpt-every", "40", "--trace-out", str(trace),
                          "--trace-every", "0.5"], env=env, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True),
    ]
    spec = LobbySpec(lobby_id="cli", target_frames=200, **SMALL)
    cli = FleetClient(("127.0.0.1", port))
    try:
        deadline = time.monotonic() + 60
        got = None
        while got is None and time.monotonic() < deadline:
            got = cli.submit(spec, timeout_s=5)
        assert got == "w0", cli.last_reject
        done = {}
        while time.monotonic() < deadline:
            try:
                lob = _fleet_json(mport)["lobbies"].get("cli", {})
            except OSError:
                lob = {}
            if lob.get("state") == "done":
                done = lob
                break
            time.sleep(0.2)
        assert done.get("final_checksum") == _control_hex(spec), done
        status = subprocess.run(
            [sys.executable, str(ROOT / "scripts" / "torch_fleet_scheduler.py"),
             "--status", f"127.0.0.1:{mport}"], capture_output=True, text=True,
            timeout=60, env=env)
        assert status.returncode == 0, status.stderr
        assert json.loads(status.stdout)["lobbies"]["cli"]["state"] == "done"
    finally:
        cli.close()
        for p in procs:
            p.send_signal(signal.SIGINT)
        outs = [p.communicate(timeout=30)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    assert "(cpu)" in outs[1]
    merged = telemetry.merge_traces(json.loads(trace.read_text()),
                                    json.loads(trace.read_text()))
    assert telemetry.validate_chrome_trace(merged) == []
    assert any(e.get("name") == "fleet_wire" for e in json.loads(trace.read_text())["traceEvents"])


def test_cli_replay_tool_reads_a_recording(tmp_path):
    """``torch_replay_tool.py`` info / checksums / diff on a port recording:
    the re-simulated checksums equal an in-process replay's."""
    from bevy_ggrs_tpu_torch import GgrsRunner, InputRecorder, InputStatus, ReplaySession
    from bevy_ggrs_tpu_torch.models import box_game

    rec = InputRecorder.for_app(box_game.make_app(device=CPU))
    rng = np.random.default_rng(4)
    confirmed = np.full(2, int(InputStatus.CONFIRMED), np.int8)
    for f in range(1, 31):
        rec.on_advance(f, rng.integers(0, 16, (2,)).astype(np.uint8), confirmed)
    path = tmp_path / "m.npz"
    rec.save(str(path))
    runner = GgrsRunner(box_game.make_app(device=CPU), ReplaySession(InputRecorder.load(str(path))))
    while not runner.session.finished:
        runner.tick()
    final = f"final frame {runner.frame}: {runner._world_checksum.to_int():#018x}"
    env = dict(os.environ, BGT_PLATFORM="cpu")
    tool = [sys.executable, str(ROOT / "scripts" / "torch_replay_tool.py")]
    out = subprocess.run(tool + ["checksums", str(path), "--every", "10"],
                         capture_output=True, text=True, timeout=120, env=env)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == final
    info = subprocess.run(tool + ["info", str(path)], capture_output=True, text=True,
                          timeout=120, env=env)
    assert info.returncode == 0 and "frames:       30" in info.stdout, info.stderr
    same = subprocess.run(tool + ["diff", str(path), str(path)], capture_output=True,
                          text=True, timeout=120, env=env)
    assert same.returncode == 0 and "recordings identical" in same.stdout


def test_cli_replay_tool_merges_reports(tmp_path):
    """``torch_replay_tool.py merge-reports``: the first divergent frame of
    two peers' reports (exit 1), their merged trace, and exit 0 on reports
    that agree."""
    def write(name, checksums, frames):
        p = tmp_path / name
        telemetry.write_desync_report("p2p_desync", path=str(p), checksums=checksums,
                                      frames=frames)
        return str(p)

    a, b = write("a.json", {1: 10, 2: 20}, [2]), write("b.json", {1: 10, 2: 21}, [2])
    trace = tmp_path / "merged.json"
    tool = [sys.executable, str(ROOT / "scripts" / "torch_replay_tool.py"), "merge-reports"]
    env = dict(os.environ, BGT_PLATFORM="cpu")
    out = subprocess.run(tool + [a, b, "--json", "--trace-out", str(trace)],
                         capture_output=True, text=True, timeout=120, env=env)
    assert out.returncode == 1, out.stderr
    assert json.loads(out.stdout)["first_divergent_frame"] == 2
    assert telemetry.validate_chrome_trace(json.loads(trace.read_text())) == []
    text = subprocess.run(tool + [a, b], capture_output=True, text=True, timeout=120, env=env)
    assert text.returncode == 1 and "FIRST DIVERGENT FRAME: 2" in text.stdout
    c, d = write("c.json", {5: 1}, []), write("d.json", {5: 1}, [])
    same = subprocess.run(tool + [c, d], capture_output=True, text=True, timeout=120, env=env)
    assert same.returncode == 0 and "no divergent frame" in same.stdout
