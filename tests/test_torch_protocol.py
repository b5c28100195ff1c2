"""The port's wire protocol and input queue, held against the JAX package.

Mirrors tests/test_protocol.py, tests/test_protocol_liveness.py and
tests/test_input_queue.py.  Every wire constant and struct format equals
the JAX module's; a port endpoint and a JAX endpoint given the same calls
on the same virtual clock send the same bytes, and a port endpoint paired
with a JAX endpoint completes the handshake and exchanges inputs,
checksums and disconnect notices.  The two ``InputQueue`` classes, fed one
seeded random op script, answer every read identically.  All of it is
exact (integer and byte equality, tolerance 0); protocol timers run on a
virtual clock, so nothing depends on the wall clock."""

import numpy as np
import pytest

from bevy_ggrs_tpu.session import input_queue as j_iq
from bevy_ggrs_tpu.session import p2p as j_p2p
from bevy_ggrs_tpu.session import protocol as j_proto
from bevy_ggrs_tpu.session import time_sync as j_ts
from bevy_ggrs_tpu_torch.session import input_queue as t_iq
from bevy_ggrs_tpu_torch.session import p2p as t_p2p
from bevy_ggrs_tpu_torch.session import protocol as t_proto
from bevy_ggrs_tpu_torch.session import time_sync as t_ts
from bevy_ggrs_tpu_torch.session.events import (
    Disconnected,
    NetworkInterrupted,
    SessionState,
    Synchronized,
)
from bevy_ggrs_tpu_torch.utils.frames import NULL_FRAME

WIRE_NAMES = sorted(
    n for n in vars(j_proto)
    if n.startswith(("T_", "S_", "_S_")) or n in (
        "MAGIC", "HDR", "PROTOCOL_VERSION", "NUM_SYNC_ROUNDTRIPS", "SYNC_RETRY_S",
        "QUALITY_INTERVAL_S", "KEEP_ALIVE_S", "ATTENDED_GAP_CAP_S",
        "MAX_INPUTS_PER_PACKET")
)


def _wire_value(v):
    return v.format if hasattr(v, "format") else v


@pytest.mark.parametrize("name", WIRE_NAMES)
def test_wire_constant_equals_jax(name):
    assert _wire_value(getattr(t_proto, name)) == _wire_value(getattr(j_proto, name))


@pytest.mark.parametrize("module, name", [
    ("p2p", "MAX_UNACKED_FRAMES"), ("p2p", "DISC_NOTICE_REBROADCAST_S"),
    ("time_sync", "WINDOW"),
])
def test_session_constant_equals_jax(module, name):
    j, t = {"p2p": (j_p2p, t_p2p), "time_sync": (j_ts, t_ts)}[module]
    assert getattr(t, name) == getattr(j, name)


@pytest.fixture
def clock(monkeypatch):
    """One virtual protocol clock for both packages' endpoints."""
    now = {"t": 100.0}
    for mod in (j_proto, t_proto, j_p2p, t_p2p):
        monkeypatch.setattr(mod, "now_s", lambda: now["t"])
    return now


def make_pair(proto_a=t_proto, proto_b=t_proto, input_size=1, **kw):
    """Two endpoints wired directly to each other's handle()."""
    a_out, b_out = [], []
    a = proto_a.PeerEndpoint(send=a_out.append, input_size=input_size,
                             rng_nonce=1, addr="B", **kw)
    b = proto_b.PeerEndpoint(send=b_out.append, input_size=input_size,
                             rng_nonce=2, addr="A", **kw)
    return a, b, a_out, b_out


def pump(a, b, a_out, b_out, rounds=10):
    for _ in range(rounds):
        a.poll()
        b.poll()
        for pkt in a_out:
            b.handle(pkt)
        a_out.clear()
        for pkt in b_out:
            a.handle(pkt)
        b_out.clear()


def _script(ep, clock):
    """A fixed call script through one endpoint (a peer that answers every
    sync request, streams inputs, reports, and then goes quiet)."""
    peer = t_proto  # the bytes the far side sends are the same in both packages
    for _ in range(3):
        ep.poll()
        clock["t"] += 0.07
    nonce = ep._sync_nonce
    for _ in range(t_proto.NUM_SYNC_ROUNDTRIPS):
        ep.handle(peer.HDR.pack(peer.MAGIC, peer.T_SYNC_REP)
                  + peer.S_SYNC_REP.pack(nonce, peer.PROTOCOL_VERSION))
        nonce = ep._sync_nonce
    ep.handle(peer.HDR.pack(peer.MAGIC, peer.T_SYNC_REQ)
              + peer.S_SYNC_REQ.pack(77, peer.PROTOCOL_VERSION))
    ep.local_advantage = 3
    pending = [(f, bytes([f % 251, 1])) for f in range(150)]
    for step in range(40):
        clock["t"] += 1 / 60
        ep.send_inputs(pending[: 10 + 3 * step])
        ep.handle(peer.HDR.pack(peer.MAGIC, peer.T_INPUT)
                  + peer.S_INPUT.pack(step, 1, step // 2, -2, 0) + bytes([step, 9]))
        ep.handle(peer.HDR.pack(peer.MAGIC, peer.T_QUAL_REQ)
                  + peer.S_QUAL_REQ.pack(int(clock["t"] * 1e6), 1))
        ep.poll()
    ep.send_checksum(33, 0xDEADBEEFCAFEBABE)
    ep.send_disc_notice(1, 31)
    ep.send_input_ack()
    for _ in range(200):
        clock["t"] += 1 / 60
        ep.poll()
    return [type(e).__name__ for e in ep.events]


def test_endpoint_sends_the_jax_bytes(clock):
    sent = {}
    for name, proto in (("jax", j_proto), ("port", t_proto)):
        clock["t"] = 100.0
        out = []
        ep = proto.PeerEndpoint(send=out.append, input_size=2, rng_nonce=12345,
                                disconnect_timeout_s=2.0,
                                disconnect_notify_start_s=0.5, addr="peer")
        events = _script(ep, clock)
        sent[name] = (out, events, ep.contig_received, ep.last_acked, ep.disconnected)
    assert len(sent["port"][0]) > 100
    assert sent["port"] == sent["jax"]


@pytest.mark.parametrize("port_side", ["a", "b"])
def test_port_endpoint_plays_jax_endpoint(clock, port_side):
    protos = (t_proto, j_proto) if port_side == "a" else (j_proto, t_proto)
    a, b, ao, bo = make_pair(*protos, input_size=2)
    pump(a, b, ao, bo)
    assert a.state.value == b.state.value == "running"
    got, sums, notices = [], [], []
    b.on_input = lambda f, raw: got.append((f, raw))
    b.on_checksum = lambda f, cs: sums.append((f, cs))
    b.on_disc_notice = lambda h, f: notices.append((h, f))
    pending = [(f, bytes([f, 255 - f])) for f in range(5)]
    a.send_inputs(pending)
    a.send_checksum(4, 0xFEEDFACE12345678)
    a.send_disc_notice(1, 3)
    for pkt in ao:
        b.handle(pkt)
    ao.clear()
    assert got == pending
    assert sums == [(4, 0xFEEDFACE12345678)]
    assert notices == [(1, 3)]
    b.send_input_ack()
    for pkt in bo:
        a.handle(pkt)
    assert a.last_acked == 4


def test_sync_handshake_completes(clock):
    a, b, ao, bo = make_pair()
    pump(a, b, ao, bo)
    assert a.state == SessionState.RUNNING
    assert b.state == SessionState.RUNNING
    assert any(isinstance(e, Synchronized) for e in a.events)
    assert any(isinstance(e, Synchronized) for e in b.events)


def test_mixed_version_pair_stalls(clock, monkeypatch):
    monkeypatch.setattr(t_proto, "PROTOCOL_VERSION", j_proto.PROTOCOL_VERSION + 1)
    a, b, ao, bo = make_pair(t_proto, j_proto)
    pump(a, b, ao, bo, rounds=20)
    assert a.state.value == b.state.value == "synchronizing"


def test_input_redundancy_and_ack(clock):
    a, b, ao, bo = make_pair()
    pump(a, b, ao, bo)
    got = []
    b.on_input = lambda f, raw: got.append((f, raw))
    pending = [(f, bytes([f])) for f in range(5)]
    a.send_inputs(pending)
    for pkt in ao:
        b.handle(pkt)
    ao.clear()
    assert got == [(f, bytes([f])) for f in range(5)]
    assert b.last_received_frame == 4
    b.send_input_ack()
    for pkt in bo:
        a.handle(pkt)
    bo.clear()
    assert a.last_acked == 4
    a.send_inputs(pending + [(5, b"\x05")])  # acked frames are not resent
    assert a.send_queue_len == 1


def test_quality_roundtrip_sets_ping(clock):
    a, b, ao, bo = make_pair()
    pump(a, b, ao, bo)
    a._last_quality_sent = 0.0
    a.poll()
    for pkt in ao:
        b.handle(pkt)
    ao.clear()
    clock["t"] += 0.03
    for pkt in bo:
        a.handle(pkt)
    assert a.ping_s == pytest.approx(0.03)


def test_disconnect_timers(clock):
    a, b, ao, bo = make_pair(disconnect_timeout_s=0.12, disconnect_notify_start_s=0.04)
    pump(a, b, ao, bo)
    a.events.clear()
    for _ in range(200):
        clock["t"] += 0.01
        a.poll()  # b never talks again
        if a.disconnected:
            break
    kinds = [type(e) for e in a.events]
    assert kinds.index(NetworkInterrupted) < kinds.index(Disconnected)


def test_malformed_packets_ignored(clock):
    a, _, _, _ = make_pair()
    H, M = t_proto.HDR, t_proto.MAGIC
    seen = []
    a.on_disc_notice = lambda h, f: seen.append((h, f))
    for pkt in (b"", b"\x00", H.pack(0x1234, 3) + b"junk", H.pack(M, 99),
                H.pack(M, t_proto.T_CHECKSUM) + b"\x01",
                H.pack(M, t_proto.T_DISC_NOTICE) + b"\x01",
                H.pack(M, t_proto.T_DISC_NOTICE), H.pack(M, t_proto.T_KEEP_ALIVE)):
        a.handle(pkt)
    assert seen == []
    assert a.state == SessionState.SYNCHRONIZING


def test_truncated_input_payload_safe(clock):
    a, b, ao, bo = make_pair(input_size=4)
    pump(a, b, ao, bo)
    got = []
    b.on_input = lambda f, raw: got.append((f, raw))
    body = t_proto.S_INPUT.pack(0, 3, -1, 0, 0) + b"\x01\x02\x03\x04\x05\x06"
    b.handle(t_proto.HDR.pack(t_proto.MAGIC, t_proto.T_INPUT) + body)
    assert got == [(0, b"\x01\x02\x03\x04")]


def test_chunk_loss_gap_refills(clock):
    a, b, ao, bo = make_pair()
    pump(a, b, ao, bo)
    got = {}
    b.on_input = lambda f, raw: got.setdefault(f, raw)
    n = t_proto.MAX_INPUTS_PER_PACKET + 20
    pending = [(f, bytes([f % 251])) for f in range(n)]
    a.send_inputs(pending)
    packets = list(ao)
    ao.clear()
    assert len(packets) == 2
    b.handle(packets[1])  # chunk 1 lost
    assert b.contig_received == -1
    b.send_input_ack()
    for pkt in bo:
        a.handle(pkt)
    bo.clear()
    assert a.last_acked == -1
    a.send_inputs(pending)
    for pkt in ao:
        b.handle(pkt)
    ao.clear()
    assert sorted(got) == list(range(n))
    assert b.contig_received == n - 1


def test_first_packets_lost_anchors_at_stream_base(clock):
    a, b, ao, bo = make_pair()
    pump(a, b, ao, bo)
    bases = []
    b.on_stream_base = bases.append
    n = t_proto.MAX_INPUTS_PER_PACKET + 10
    pending = [(f + 5, bytes([f % 251])) for f in range(n)]
    a.send_inputs(pending)
    packets = list(ao)
    ao.clear()
    b.handle(packets[1])
    assert bases == [5]
    assert b.contig_received == 4
    a.send_inputs(pending)
    for pkt in ao:
        b.handle(pkt)
    assert b.contig_received == 5 + n - 1


def _running_ep(timeout, notify):
    ep = t_proto.PeerEndpoint(send=lambda b: None, input_size=1, rng_nonce=1,
                              disconnect_timeout_s=timeout,
                              disconnect_notify_start_s=notify, addr="peer")
    ep.state = SessionState.RUNNING
    return ep


def test_host_stall_does_not_disconnect_live_peer(clock):
    ep = _running_ep(2.0, 0.5)
    keepalive = t_proto.HDR.pack(t_proto.MAGIC, t_proto.T_KEEP_ALIVE)
    for _ in range(5):
        clock["t"] += 10.0  # host frozen; the peer was alive
        ep.poll()
        assert not ep.disconnected
        ep.handle(keepalive)
        assert ep._quiet_s == 0.0


def test_attended_silence_disconnects_near_the_timeout(clock):
    ep = _running_ep(2.0, 0.5)
    for i in range(400):
        clock["t"] += 1.0 / 60.0
        ep.poll()
        if ep.disconnected:
            break
    assert ep.disconnected
    assert 110 <= i <= 140
    kinds = [type(e) for e in ep.events]
    assert kinds.index(NetworkInterrupted) < kinds.index(Disconnected)
    # once disconnected, late packets are ignored
    seen = []
    ep.on_input = lambda f, raw: seen.append(f)
    ep.handle(t_proto.HDR.pack(t_proto.MAGIC, t_proto.T_INPUT)
              + t_proto.S_INPUT.pack(0, 1, -1, 0, 0) + b"\x01")
    assert seen == []


# -- InputQueue ----------------------------------------------------------------


def _drive_queue(mod, seed, delay, shape):
    """Use one ``InputQueue`` as the P2P session does, from a seeded rng:
    a remote stream (delay 0) arriving late, out of order and redundantly,
    or a local stream (delay > 0); each tick takes the first incorrect
    frame, serves inputs from it to the present, reads a confirmed input
    and collects garbage.  Returns every answer the queue gave."""
    rng = np.random.default_rng(seed)
    q = mod.InputQueue(shape, np.uint8, delay=delay)
    trace = []
    stream, sent, value = {}, 0, 0
    for cur in range(150):
        if rng.random() < 0.25:
            value = int(rng.integers(0, 4))
        if delay:
            trace.append(("add_local", q.add_local(cur, np.full(shape, value, np.uint8))))
        else:
            if cur == 0:
                q.set_base(0)
            stream[cur] = value
            newest = cur - int(rng.integers(0, 5))
            arrivals = list(range(max(sent - 3, 0), newest + 1))
            rng.shuffle(arrivals)
            for f in arrivals:
                q.add_remote(f, np.full(shape, stream[f], np.uint8))
            sent = max(sent, newest + 1)
        fi = q.take_first_incorrect()
        trace.append(("take", fi, q.first_incorrect_mismatch))
        for f in range(fi if NULL_FRAME < fi < cur else cur, cur + 1):
            v, st = q.input_for(f)
            trace.append(("input_for", f, np.asarray(v).tolist(), int(st)))
        c = q.confirmed_input(cur - 4)
        trace.append(("confirmed", None if c is None else c.tolist(), q.last_confirmed))
        if cur % 10 == 9:
            q.gc(cur - 20)
        if cur == 120 and not delay:
            q.truncate_after(q.last_confirmed - 3)
            trace.append(("truncated", q.last_confirmed, q.first_incorrect))
    return trace


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("delay, shape", [(0, ()), (2, (3,))])
def test_input_queue_equals_jax_on_random_script(seed, delay, shape):
    got = _drive_queue(t_iq, seed, delay, shape)
    assert got == _drive_queue(j_iq, seed, delay, shape)
    if not delay:  # the late remote stream was mispredicted and corrected
        assert any(t[0] == "take" and t[1] != NULL_FRAME for t in got)


def test_input_queue_basics():
    q = t_iq.InputQueue(delay=3)
    assert q.add_local(0, 7) == 3
    v, st = q.input_for(3)
    assert int(v) == 7 and st == 0
    v, st = q.input_for(1)  # before the delayed input: default, predicted
    assert int(v) == 0 and st == 1
    q = t_iq.InputQueue()
    q.add_remote(0, 5)
    for f in (1, 2, 3):
        q.input_for(f)
    q.add_remote(1, 5)  # matches the served prediction
    assert q.first_incorrect == NULL_FRAME
    q.add_remote(2, 9)
    q.add_remote(3, 9)
    assert q.take_first_incorrect() == 2
    assert q.first_incorrect == NULL_FRAME
