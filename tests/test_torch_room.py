"""The port's room matchmaking transport (``session/room.py``), mirroring
``tests/test_room.py`` (12 tests) with port rooms, sessions and runners:
peers join a room on a signaling server, learn each other's peer ids, and
play a P2P session addressed by peer id over the direct and the relayed
data planes; roster pruning, hardening, join tokens.  Across the packages:
the port's packets are the JAX package's bytes, and two port sockets pair
up through a JAX ``RoomServer`` and play a port ``fixed_point`` pair over
it, in sync."""

import time

import numpy as np
import pytest
import torch

from bevy_ggrs_tpu_torch import (
    GgrsRunner,
    PlayerType,
    RoomServer,
    RoomSocket,
    SessionBuilder,
    SessionState,
    assign_handles,
    wait_for_players,
)
from bevy_ggrs_tpu_torch.models import box_game

DT = 1.0 / 60.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _room_pair(mode, room="game-1"):
    server = RoomServer(host="127.0.0.1")
    addr = server.local_addr
    socks = [
        RoomSocket(addr, room, peer_id=f"peer-{i}", mode=mode,
                   host="127.0.0.1")
        for i in range(2)
    ]
    for s in socks:
        wait_for_players(s, 2, timeout_s=5.0, server=server)
    return server, socks


def test_join_roster_and_handle_assignment():
    server, socks = _room_pair("direct")
    for s in socks:
        assert s.players() == ["peer-0", "peer-1"]
        # every peer derives the identical handle map with no coordination
        assert assign_handles(s) == {0: "peer-0", 1: "peer-1"}
    server.close()
    for s in socks:
        s.close()


def test_datagrams_by_peer_id_direct_and_relay():
    for mode in ("direct", "relay"):
        server, socks = _room_pair(mode, room=f"dgram-{mode}")
        socks[0].send_to(b"hello", "peer-1")
        got = []
        deadline = time.monotonic() + 3.0
        while time.monotonic() < deadline and not got:
            server.poll()
            got = socks[1].receive_all()
            time.sleep(0.002)
        assert got == [("peer-0", b"hello")], (mode, got)
        # unknown destination: dropped silently (UDP semantics)
        socks[0].send_to(b"void", "peer-9")
        server.poll()
        server.close()
        for s in socks:
            s.close()


def test_member_timeout_prunes_roster():
    # timeout intentionally SHORTER than the ping interval: the live peer
    # also gets pruned at first, and must self-heal via re-JOIN while the
    # silent one stays gone
    server = RoomServer(host="127.0.0.1", member_timeout_s=0.3)
    addr = server.local_addr
    a = RoomSocket(addr, "prune", peer_id="alive", host="127.0.0.1")
    b = RoomSocket(addr, "prune", peer_id="doomed", host="127.0.0.1")
    wait_for_players(a, 2, timeout_s=5.0, server=server)
    # b goes silent; a keeps pinging
    deadline = time.monotonic() + 5.0
    while time.monotonic() < deadline:
        server.poll()
        a.receive_all()
        if a.players() == ["alive"]:
            break
        time.sleep(0.02)
    assert a.players() == ["alive"]
    server.close()
    a.close()
    b.close()


@pytest.mark.parametrize("mode", ["direct", "relay"])
def test_p2p_session_over_room_socket(mode):
    """The full drop-in: SessionBuilder players addressed by peer id over a
    RoomSocket; handshake, play, rollback-capable agreement."""
    server, socks = _room_pair(mode, room=f"p2p-{mode}")
    runners = []
    for i, sock in enumerate(socks):
        handles = assign_handles(sock)
        app = box_game.make_app(num_players=2, device="cpu")
        b = SessionBuilder.for_app(app).with_input_delay(1)
        for h, peer in handles.items():
            if peer == sock.peer_id:
                b.add_player(PlayerType.LOCAL, h)
            else:
                b.add_player(PlayerType.REMOTE, h, peer)
        session = b.start_p2p_session(sock)

        def read_inputs(hs, i=i):
            key = {0: "right", 1: "down"}[i]
            return {h: box_game.keys_to_input(**{key: True}) for h in hs}

        runners.append(GgrsRunner(app, session, read_inputs=read_inputs))

    deadline = time.monotonic() + 10.0
    while time.monotonic() < deadline:
        server.poll()
        for r in runners:
            r.update(0.0)
        if all(
            r.session.current_state() == SessionState.RUNNING for r in runners
        ):
            break
        time.sleep(0.002)
    assert all(
        r.session.current_state() == SessionState.RUNNING for r in runners
    )

    for _ in range(120):
        server.poll()
        for r in runners:
            r.update(DT)
    assert all(r.frame >= 100 for r in runners)
    shared = sorted(set(runners[0].ring.frames()) & set(runners[1].ring.frames()))
    if not shared:
        for _ in range(3):
            server.poll()
            for r in runners:
                r.update(DT)
        shared = sorted(
            set(runners[0].ring.frames()) & set(runners[1].ring.frames())
        )
    assert shared
    f = shared[-1]
    assert runners[0].ring.peek(f)[1]() == runners[1].ring.peek(f)[1]()
    # remote input actually arrived (player moved on the OTHER peer's world)
    assert float(runners[0].world.comps["pos"][1, 1]) > 0.5
    server.close()
    for s in socks:
        s.close()


def test_room_socket_fuzz_resilience():
    """Garbage at both the server and the socket must never crash or
    corrupt the roster (untrusted UDP input, same posture as the session
    protocol fuzz test)."""
    import random
    import socket as so

    server, socks = _room_pair("direct", room="fuzz")
    fz = so.socket(so.AF_INET, so.SOCK_DGRAM)
    fz.bind(("127.0.0.1", 0))
    rng = random.Random(7)
    targets = [server.local_addr, socks[0].local_addr]
    for i in range(2000):
        n = rng.randrange(0, 128)
        buf = bytes(rng.randrange(256) for _ in range(n))
        if rng.random() < 0.5 and n >= 3:
            buf = b"\xa7\x52" + buf[2:]  # valid magic, evil body
        fz.sendto(buf, targets[i % 2])
        if i % 100 == 0:
            server.poll()
            socks[0].receive_all()
    server.poll()
    for s in socks:
        s.receive_all()
    assert socks[0].players() == ["peer-0", "peer-1"]
    # data plane still works after the storm
    socks[0].send_to(b"after", "peer-1")
    got = []
    deadline = time.monotonic() + 3.0
    while time.monotonic() < deadline and not got:
        server.poll()
        got = socks[1].receive_all()
        time.sleep(0.002)
    assert got == [("peer-0", b"after")]
    fz.close()
    server.close()
    for s in socks:
        s.close()


def test_room_member_cap_and_socket_move():
    """Server hardening: a room never exceeds MAX_ROOM_MEMBERS (the roster
    count is one wire byte — overflow used to crash the server), and a
    socket re-JOINing a different room MOVES: its old membership dies
    immediately so pruning it can never orphan the live registration."""
    import socket as so
    import struct as st

    from bevy_ggrs_tpu_torch.session.room import (
        MAX_ROOM_MEMBERS,
        ROOM_MAGIC,
        _HDR,
        _JOIN,
        _pack_str,
    )

    server = RoomServer(host="127.0.0.1")
    addr = server.local_addr
    flood = so.socket(so.AF_INET, so.SOCK_DGRAM)
    flood.bind(("127.0.0.1", 0))
    for i in range(MAX_ROOM_MEMBERS + 200):
        pkt = _HDR.pack(ROOM_MAGIC, _JOIN) + _pack_str("big") + _pack_str(f"p{i}")
        flood.sendto(pkt, addr)
        if i % 50 == 0:
            server.poll()
    server.poll()  # must not raise (the old crash was bytes([256]))
    assert len(server.rooms["big"]) <= MAX_ROOM_MEMBERS
    flood.close()

    a = RoomSocket(addr, "first", peer_id="mover", host="127.0.0.1")
    wait_for_players(a, 1, timeout_s=5.0, server=server)
    assert "first" in server.rooms
    # same socket joins another room: membership moves, old room empties
    a.room = "second"
    a._join()
    deadline = time.monotonic() + 3.0
    while time.monotonic() < deadline:
        server.poll()
        a.receive_all()
        if "first" not in server.rooms and "second" in server.rooms:
            break
        time.sleep(0.01)
    assert "first" not in server.rooms
    assert sorted(server.rooms["second"]) == ["mover"]
    server.close()
    a.close()


def test_forged_control_packets_are_ignored():
    """Source-address validation: rosters/relays must come from the server,
    direct data from the roster address — a forged ROSTER would otherwise
    hijack the data plane wholesale."""
    import socket as so
    import struct as st

    from bevy_ggrs_tpu_torch.session.room import ROOM_MAGIC, _HDR, _pack_str

    server, socks = _room_pair("direct", room="spoof")
    atk = so.socket(so.AF_INET, so.SOCK_DGRAM)
    atk.bind(("127.0.0.1", 0))
    # forged roster pointing peer-1 at the attacker
    evil = (_HDR.pack(ROOM_MAGIC, 2) + _pack_str("spoof") + bytes([1])
            + _pack_str("peer-1") + _pack_str("127.0.0.1")
            + st.pack("<H", atk.getsockname()[1]))
    atk.sendto(evil, socks[0].local_addr)
    time.sleep(0.05)
    before = dict(socks[0].roster)
    socks[0].receive_all()
    assert socks[0].roster == before  # forged roster rejected
    # forged direct DATA claiming to be peer-1 from the attacker's addr
    fake = _HDR.pack(ROOM_MAGIC, 3) + _pack_str("peer-1") + b"evil"
    atk.sendto(fake, socks[0].local_addr)
    time.sleep(0.05)
    got = socks[0].receive_all()
    assert ("peer-1", b"evil") not in got
    # forged FWD not from the server: also dropped
    fwd = _HDR.pack(ROOM_MAGIC, 5) + _pack_str("peer-1") + b"evil2"
    atk.sendto(fwd, socks[0].local_addr)
    time.sleep(0.05)
    got = socks[0].receive_all()
    assert all(payload != b"evil2" for _, payload in got)
    # the legit plane still works
    socks[1].send_to(b"legit", "peer-0")
    got = []
    deadline = time.monotonic() + 3.0
    while time.monotonic() < deadline and not got:
        server.poll()
        got = socks[0].receive_all()
        time.sleep(0.002)
    assert got == [("peer-1", b"legit")]
    atk.close()
    server.close()
    for s in socks:
        s.close()


def test_move_to_full_room_keeps_old_membership():
    """A JOIN rejected for capacity must not deregister the mover from its
    previous room."""
    from bevy_ggrs_tpu_torch.session import room as room_mod

    old_cap = room_mod.MAX_ROOM_MEMBERS
    room_mod.MAX_ROOM_MEMBERS = 1
    try:
        server = RoomServer(host="127.0.0.1")
        addr = server.local_addr
        a = RoomSocket(addr, "origin", peer_id="mover", host="127.0.0.1")
        blocker = RoomSocket(addr, "fullroom", peer_id="resident",
                             host="127.0.0.1")
        wait_for_players(a, 1, timeout_s=5.0, server=server)
        wait_for_players(blocker, 1, timeout_s=5.0, server=server)
        a.room = "fullroom"
        a._join()
        for _ in range(20):
            server.poll()
            time.sleep(0.005)
        assert sorted(server.rooms["fullroom"]) == ["resident"]
        assert sorted(server.rooms["origin"]) == ["mover"]  # still seated
        server.close()
        a.close()
        blocker.close()
    finally:
        room_mod.MAX_ROOM_MEMBERS = old_cap


def test_join_token_matching_clients_pair_up():
    server = RoomServer(host="127.0.0.1", join_token="s3cret")
    addr = server.local_addr
    socks = [
        RoomSocket(addr, "locked", peer_id=f"peer-{i}", host="127.0.0.1",
                   join_token="s3cret")
        for i in range(2)
    ]
    for s in socks:
        assert wait_for_players(s, 2, timeout_s=5.0, server=server) == [
            "peer-0", "peer-1"
        ]
    server.close()
    for s in socks:
        s.close()


def test_join_token_mismatch_rejected_with_reason():
    server = RoomServer(host="127.0.0.1", join_token="s3cret")
    addr = server.local_addr
    s = RoomSocket(addr, "locked", peer_id="intruder", host="127.0.0.1",
                   join_token="wrong")
    with pytest.raises(PermissionError, match="bad join token"):
        wait_for_players(s, 1, timeout_s=5.0, server=server)
    assert server.rooms.get("locked") in (None, {})
    server.close()
    s.close()


def test_join_token_absent_client_rejected_by_token_server():
    # a pre-token client sends no trailing token field; a token-requiring
    # server must still refuse it (empty != configured token)
    server = RoomServer(host="127.0.0.1", join_token="s3cret")
    addr = server.local_addr
    s = RoomSocket(addr, "locked", peer_id="legacy", host="127.0.0.1")
    with pytest.raises(PermissionError, match="bad join token"):
        wait_for_players(s, 1, timeout_s=5.0, server=server)
    server.close()
    s.close()


def test_token_client_compatible_with_tokenless_server():
    # forward compat: the trailing token field is ignored by servers that
    # never configured one
    server = RoomServer(host="127.0.0.1")
    addr = server.local_addr
    s = RoomSocket(addr, "open", peer_id="newcli", host="127.0.0.1",
                   join_token="s3cret")
    assert wait_for_players(s, 1, timeout_s=5.0, server=server) == ["newcli"]
    server.close()
    s.close()


# -- across the packages -------------------------------------------------------------


def test_wire_bytes_equal_the_jax_package():
    from bevy_ggrs_tpu.session import room as j_room
    from bevy_ggrs_tpu_torch.session import room as t_room

    assert t_room.ROOM_MAGIC == j_room.ROOM_MAGIC and t_room._HDR.format == j_room._HDR.format
    for name in ("_JOIN", "_ROSTER", "_DATA", "_RELAY", "_FWD", "_PING", "_LEAVE",
                 "_REJECT", "MAX_ROOM_MEMBERS", "PING_INTERVAL_S", "MEMBER_TIMEOUT_S",
                 "REJOIN_AFTER_S"):
        assert getattr(t_room, name) == getattr(j_room, name), name
    for s in ("", "peer-0", "ü" * 40):
        assert t_room._pack_str(s) == j_room._pack_str(s)
    servers = [t_room.RoomServer(host="127.0.0.1"), j_room.RoomServer(host="127.0.0.1")]
    for srv in servers:
        srv.rooms["r"] = {"b": (("127.0.0.1", 4000), 0.0), "a": (("10.0.0.2", 5), 0.0)}
    assert servers[0]._roster_packet("r") == servers[1]._roster_packet("r")
    for srv in servers:
        srv.close()


def test_port_pair_through_a_jax_room_server():
    """Two port sockets pair up through the JAX package's server (relay
    mode, so every game datagram crosses it) and a port fixed_point pair
    plays 120 frames over them: in sync, confirmed checksums equal."""
    from bevy_ggrs_tpu.session.room import RoomServer as JRoomServer
    from bevy_ggrs_tpu_torch import DesyncDetection
    from bevy_ggrs_tpu_torch.models import fixed_point
    from bevy_ggrs_tpu_torch.session.events import DesyncDetected

    server = JRoomServer(host="127.0.0.1")
    socks = [RoomSocket(server.local_addr, "mixed", peer_id=f"peer-{i}", mode="relay",
                        host="127.0.0.1") for i in range(2)]
    for s in socks:
        assert wait_for_players(s, 2, timeout_s=5.0, server=server) == ["peer-0", "peer-1"]
    runners = []
    for i, sock in enumerate(socks):
        app = fixed_point.make_app(device="cpu")
        b = (SessionBuilder.for_app(app).with_input_delay(1)
             .with_desync_detection_mode(DesyncDetection.on(1)))
        for h, peer in assign_handles(sock).items():
            if peer == sock.peer_id:
                b.add_player(PlayerType.LOCAL, h)
            else:
                b.add_player(PlayerType.REMOTE, h, peer)
        holder = []

        def read_inputs(hs, i=i, holder=holder):
            return {h: np.uint8(((holder[0].frame // 7) + i) & 0xF) for h in hs}

        runners.append(GgrsRunner(app, b.start_p2p_session(sock), read_inputs=read_inputs))
        holder.append(runners[-1])
    deadline = time.monotonic() + 10.0
    while time.monotonic() < deadline:
        server.poll()
        for r in runners:
            r.update(0.0)
        if all(r.session.current_state() == SessionState.RUNNING for r in runners):
            break
        time.sleep(0.002)
    assert all(r.session.current_state() == SessionState.RUNNING for r in runners)
    for _ in range(120):
        server.poll()
        for r in runners:
            r.update(DT)
    assert all(r.frame >= 100 for r in runners)
    for r in runners:
        r.finish()
    assert not [e for r in runners for e in r.events if isinstance(e, DesyncDetected)]
    shared = sorted(set(runners[0].ring.frames()) & set(runners[1].ring.frames()))
    horizon = min(r.confirmed for r in runners)
    shared = [f for f in shared if f <= horizon]
    assert shared
    for f in shared:
        assert runners[0].ring.peek(f)[1]() == runners[1].ring.peek(f)[1]()
    server.close()
    for s in socks:
        s.close()
