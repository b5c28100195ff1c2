"""Room-based matchmaking transport — the matchbox/WebRTC analog.

Port of ``bevy_ggrs_tpu/session/room.py`` (host only): the same wire bytes,
so port sockets and JAX-package sockets share one room server.

The reference pairs with `matchbox` for browser P2P (its README's
matchbox section): peers join a ROOM on a signaling server,
learn each other's PeerIds, then exchange unreliable datagrams addressed
BY PEER ID over data channels.  This module provides the same developer
contract over UDP, in the framework's non-blocking polling style:

- :class:`RoomServer` — the signaling/relay node.  Tracks room rosters,
  pushes roster updates to every member on change, prunes silent members,
  and forwards relayed datagrams (the TURN-style data plane, so two peers
  that cannot reach each other directly still play).
- :class:`RoomSocket` — a :class:`~.transport.NonBlockingSocket` whose
  ``addr`` IS the peer id (a string), drop-in for
  ``SessionBuilder.add_player(PlayerType.REMOTE, handle, peer_id)``.
  ``mode="direct"`` sends game datagrams straight to the roster address
  (STUN-style, LAN/loopback); ``mode="relay"`` bounces them through the
  server (works anywhere the server is reachable).
- :func:`assign_handles` — the matchbox convention: sort peer ids, index
  = player handle, so every peer derives the same handle assignment with
  no extra coordination.

Wire format: own magic (0x52A7) so room traffic can never be confused
with session packets; length-prefixed UTF-8 ids; payloads are opaque.
Untrusted input: every decoder bails on malformed bytes (same posture as
session/protocol.py).
"""

from __future__ import annotations

import socket as _socket
import struct
import time
import uuid
from typing import Any, Dict, List, Optional, Tuple

ROOM_MAGIC = 0x52A7
_HDR = struct.Struct("<HB")
# message types
_JOIN = 1      # c->s: room, peer_id
_ROSTER = 2    # s->c: room, [(peer_id, ip, port)...]
_DATA = 3      # c->c (direct): src_peer_id + payload
_RELAY = 4     # c->s: dst_peer_id + payload
_FWD = 5       # s->c: src_peer_id + payload
_PING = 6      # c->s keepalive (also re-requests the roster)
_LEAVE = 7     # c->s: explicit departure
_REJECT = 8    # s->c: room, reason (join refused — e.g. bad join token)

PING_INTERVAL_S = 0.5
MEMBER_TIMEOUT_S = 5.0
# hard cap per room: bounds roster-packet size (the member count is one
# byte on the wire) and stops a single socket from growing a room without
# limit by joining under many peer ids
MAX_ROOM_MEMBERS = 64
# a client that has not seen a roster for this long re-JOINs instead of
# pinging: pings from pruned members are ignored (the server no longer
# knows the addr), so re-registration is the self-heal path — it also
# survives a server restart
REJOIN_AFTER_S = 1.5


def _pack_str(s: str) -> bytes:
    b = s.encode("utf-8")
    if len(b) > 255:
        raise ValueError("room/peer id longer than 255 bytes")
    return bytes([len(b)]) + b


class _Reader:
    __slots__ = ("b", "i", "ok")

    def __init__(self, b: bytes):
        self.b = b
        self.i = 0
        self.ok = True

    def take(self, n: int) -> bytes:
        if self.i + n > len(self.b):
            self.ok = False
            return b""
        out = self.b[self.i:self.i + n]
        self.i += n
        return out

    def u8(self) -> int:
        d = self.take(1)
        return d[0] if self.ok else 0

    def u16(self) -> int:
        d = self.take(2)
        return struct.unpack("<H", d)[0] if self.ok else 0

    def s(self) -> str:
        n = self.u8()
        d = self.take(n)
        if not self.ok:
            return ""
        try:
            return d.decode("utf-8")
        except UnicodeDecodeError:
            self.ok = False
            return ""

    def rest(self) -> bytes:
        out = self.b[self.i:]
        self.i = len(self.b)
        return out


class RoomServer:
    """Signaling + relay server.  Drive with :meth:`poll` (non-blocking) —
    from a game loop or a thread."""

    def __init__(self, port: int = 0, host: str = "0.0.0.0",
                 member_timeout_s: float = MEMBER_TIMEOUT_S,
                 join_token: Optional[str] = None):
        self._sock = _socket.socket(_socket.AF_INET, _socket.SOCK_DGRAM)
        self._sock.setblocking(False)
        self._sock.bind((host, port))
        self.member_timeout_s = member_timeout_s
        # optional shared-secret admission control (off by default): when
        # set, a JOIN must carry the same token or it is rejected with a
        # reason.  This closes the "any addr can join/kick/impersonate a
        # peer id" hole for deployments that can distribute a secret; it
        # is NOT transport encryption — see docs/architecture.md
        # "Trust model (networking)".
        self.join_token = join_token
        # room -> peer_id -> (addr, last_seen)
        self.rooms: Dict[str, Dict[str, Tuple[Any, float]]] = {}
        self._addr_index: Dict[Any, Tuple[str, str]] = {}  # addr -> (room, peer)

    @property
    def local_addr(self) -> Tuple[str, int]:
        return self._sock.getsockname()

    def poll(self) -> None:
        """Drain the socket; answer joins/pings, forward relays, prune."""
        while True:
            try:
                data, addr = self._sock.recvfrom(65536)
            except (BlockingIOError, OSError):
                break
            self._handle(data, addr)
        self._prune()

    def _handle(self, data: bytes, addr) -> None:
        if len(data) < _HDR.size:
            return
        magic, t = _HDR.unpack_from(data)
        if magic != ROOM_MAGIC:
            return
        r = _Reader(data[_HDR.size:])
        now = time.monotonic()
        if t == _JOIN:
            # membership is claimed, not authenticated unless a join token
            # is configured (trusted-network model — docs/architecture.md
            # "Trust model (networking)")
            room, peer = r.s(), r.s()
            if not r.ok or not room or not peer:
                return
            # optional trailing token field: absent in pre-token clients
            # (old servers likewise ignore the trailing bytes, so a
            # token-carrying client stays compatible with them)
            token = r.s() if r.i < len(r.b) else ""
            if self.join_token is not None and token != self.join_token:
                out = (_HDR.pack(ROOM_MAGIC, _REJECT) + _pack_str(room)
                       + _pack_str("bad join token"))
                self._send(out, addr)
                return
            # destination capacity FIRST: a rejected move must leave the
            # old membership intact (dropping it before the check would
            # deregister the socket entirely on a full destination)
            members = self.rooms.setdefault(room, {})
            prev = self._addr_index.get(addr)
            occupied = len(members)
            if (
                prev is not None
                and prev[0] == room
                and prev[1] in members
                and members[prev[1]][0] == addr
            ):
                # the joining socket already holds a slot HERE — a rejoin
                # under a new peer id frees it, so it must not count against
                # capacity (a full room would otherwise reject its own member)
                occupied -= 1
            if peer not in members and occupied >= MAX_ROOM_MEMBERS:
                return  # room full: drop the join (bounds the roster byte)
            # one socket = one membership: a JOIN from an addr already
            # registered elsewhere moves it (otherwise _prune on the stale
            # membership would pop the LIVE _addr_index entry and the
            # member's pings/relays would be silently ignored)
            if prev is not None and prev != (room, peer):
                self._drop_member(*prev, broadcast=True)
                members = self.rooms.setdefault(room, {})
            old = members.get(peer)
            if old is not None and old[0] != addr:
                # same peer id re-joining from a new port: retire the old
                # addr's index entry so a datagram from the recycled addr
                # can never flip the roster back to a dead socket
                self._addr_index.pop(old[0], None)
            members[peer] = (addr, now)
            self._addr_index[addr] = (room, peer)
            self._broadcast_roster(room)
        elif t == _PING:
            entry = self._addr_index.get(addr)
            if entry is None:
                return
            room, peer = entry
            members = self.rooms.get(room)
            if members is not None and peer in members:
                members[peer] = (addr, now)
                self._send_roster(room, addr)
        elif t == _RELAY:
            entry = self._addr_index.get(addr)
            if entry is None:
                return  # relays only for joined members
            room, src_peer = entry
            dst = r.s()
            payload = r.rest()
            if not r.ok:
                return
            members = self.rooms.get(room, {})
            got = members.get(dst)
            if got is None:
                return  # unknown / departed peer: drop (UDP semantics)
            members[src_peer] = (addr, now)  # relaying proves liveness
            out = _HDR.pack(ROOM_MAGIC, _FWD) + _pack_str(src_peer) + payload
            self._send(out, got[0])
        elif t == _LEAVE:
            entry = self._addr_index.get(addr)
            if entry is None:
                return
            self._drop_member(*entry, broadcast=True)

    def _drop_member(self, room: str, peer: str, broadcast: bool) -> None:
        members = self.rooms.get(room)
        if members is None:
            return
        got = members.pop(peer, None)
        if got is None:
            return
        self._addr_index.pop(got[0], None)
        if not members:
            del self.rooms[room]
        elif broadcast:
            self._broadcast_roster(room)

    def _prune(self) -> None:
        now = time.monotonic()
        for room in list(self.rooms):
            members = self.rooms[room]
            dead = [
                p for p, (addr, seen) in members.items()
                if now - seen > self.member_timeout_s
            ]
            for p in dead:
                self._drop_member(room, p, broadcast=False)
            if dead and room in self.rooms:
                self._broadcast_roster(room)

    def _roster_packet(self, room: str) -> bytes:
        members = self.rooms.get(room, {})
        out = _HDR.pack(ROOM_MAGIC, _ROSTER) + _pack_str(room)
        out += bytes([len(members)])
        for peer, (addr, _) in sorted(members.items()):
            ip, port = addr
            out += _pack_str(peer) + _pack_str(ip) + struct.pack("<H", port)
        return out

    def _broadcast_roster(self, room: str) -> None:
        pkt = self._roster_packet(room)
        for peer, (addr, _) in self.rooms.get(room, {}).items():
            self._send(pkt, addr)

    def _send_roster(self, room: str, addr) -> None:
        self._send(self._roster_packet(room), addr)

    def _send(self, data: bytes, addr) -> None:
        try:
            self._sock.sendto(data, addr)
        except (BlockingIOError, OSError):
            pass

    def close(self) -> None:
        self._sock.close()


class RoomSocket:
    """Peer-id-addressed NonBlockingSocket over a :class:`RoomServer`.

    ``send_to(data, peer_id)`` / ``receive_all() -> [(peer_id, bytes)]`` —
    exactly the session transport protocol, with peer ids as addresses
    (the matchbox contract).  Construct, then drive :meth:`poll_roster`
    (or just call :func:`wait_for_players`) until the room is full, then
    hand to ``SessionBuilder``."""

    def __init__(self, server_addr: Tuple[str, int], room: str,
                 peer_id: Optional[str] = None, mode: str = "direct",
                 port: int = 0, host: str = "0.0.0.0",
                 join_token: Optional[str] = None):
        if mode not in ("direct", "relay"):
            raise ValueError("mode must be 'direct' or 'relay'")
        # resolve once: inbound packets are validated against the source
        # address recvfrom() reports, which is always a numeric IP — a
        # hostname here would never match and all rosters would be dropped
        sip, sport = server_addr
        self.server_addr = (_socket.gethostbyname(sip), int(sport))
        self.room = room
        self.peer_id = peer_id or uuid.uuid4().hex[:12]
        self.mode = mode
        self._sock = _socket.socket(_socket.AF_INET, _socket.SOCK_DGRAM)
        self._sock.setblocking(False)
        self._sock.bind((host, port))
        self.roster: Dict[str, Tuple[str, int]] = {}  # peer_id -> addr
        self.join_token = join_token
        self.last_reject: Optional[str] = None  # server's refusal reason
        self._last_ping = 0.0
        self._last_roster = time.monotonic()
        self._join()

    @property
    def local_addr(self) -> Tuple[str, int]:
        return self._sock.getsockname()

    def _join(self) -> None:
        pkt = (_HDR.pack(ROOM_MAGIC, _JOIN)
               + _pack_str(self.room) + _pack_str(self.peer_id))
        if self.join_token is not None:
            # trailing field: old servers ignore it (backward compatible)
            pkt += _pack_str(self.join_token)
        self._raw_send(pkt, self.server_addr)

    def players(self) -> List[str]:
        """Connected peer ids (self included), sorted — the matchbox
        ``players()`` analog; index in this list = player handle
        (see :func:`assign_handles`)."""
        ids = set(self.roster) | {self.peer_id}
        return sorted(ids)

    # -- NonBlockingSocket protocol -----------------------------------------

    def send_to(self, data: bytes, addr: Any) -> None:
        """Send a game datagram to a PEER ID."""
        peer = str(addr)
        if self.mode == "relay":
            pkt = _HDR.pack(ROOM_MAGIC, _RELAY) + _pack_str(peer) + data
            self._raw_send(pkt, self.server_addr)
            return
        got = self.roster.get(peer)
        if got is None:
            return  # not in the roster (yet): drop, UDP semantics
        pkt = _HDR.pack(ROOM_MAGIC, _DATA) + _pack_str(self.peer_id) + data
        self._raw_send(pkt, got)

    def receive_all(self) -> List[Tuple[Any, bytes]]:
        """Drain: game datagrams as ``(peer_id, payload)``; roster/control
        packets are consumed internally.  Also drives the keepalive."""
        out: List[Tuple[Any, bytes]] = []
        while True:
            try:
                data, addr = self._sock.recvfrom(65536)
            except (BlockingIOError, OSError):
                break
            got = self._handle(data, addr)
            if got is not None:
                out.append(got)
        now = time.monotonic()
        if now - self._last_ping >= PING_INTERVAL_S:
            self._last_ping = now
            if now - self._last_roster > REJOIN_AFTER_S:
                self._join()  # pruned or server restarted: re-register
            else:
                self._raw_send(_HDR.pack(ROOM_MAGIC, _PING), self.server_addr)
        return out

    # -- internals -----------------------------------------------------------

    def _handle(self, data: bytes, addr) -> Optional[Tuple[str, bytes]]:
        if len(data) < _HDR.size:
            return None
        magic, t = _HDR.unpack_from(data)
        if magic != ROOM_MAGIC:
            return None
        r = _Reader(data[_HDR.size:])
        if t == _ROSTER:
            if addr != self.server_addr:
                return None  # rosters are authoritative: server-origin only
            room = r.s()
            n = r.u8()
            if not r.ok or room != self.room:
                return None
            roster: Dict[str, Tuple[str, int]] = {}
            for _ in range(n):
                peer, ip, port = r.s(), r.s(), r.u16()
                if not r.ok:
                    return None
                if peer != self.peer_id:
                    roster[peer] = (ip, port)
            self.roster = roster
            self._last_roster = time.monotonic()
            return None
        if t == _REJECT:
            if addr != self.server_addr:
                return None  # rejections are authoritative: server-origin only
            room, reason = r.s(), r.s()
            if r.ok and room == self.room:
                self.last_reject = reason or "join rejected"
            return None
        if t == _FWD:
            if addr != self.server_addr:
                return None  # relayed data comes only from the server
            src = r.s()
            payload = r.rest()
            if not r.ok or not src:
                return None
            return (src, payload)
        if t == _DATA:
            src = r.s()
            payload = r.rest()
            if not r.ok or not src:
                return None
            if self.roster.get(src) != addr:
                return None  # direct data must come from the roster addr
            return (src, payload)
        return None

    def poll_roster(self) -> List[str]:
        """Drive control traffic only (pre-session); returns players()."""
        self.receive_all()
        return self.players()

    def leave(self) -> None:
        self._raw_send(_HDR.pack(ROOM_MAGIC, _LEAVE), self.server_addr)

    def _raw_send(self, data: bytes, addr) -> None:
        try:
            self._sock.sendto(data, addr)
        except (BlockingIOError, OSError):
            pass

    def close(self) -> None:
        """LEAVE the room (so the roster updates promptly) and close."""
        self.leave()
        self._sock.close()


def wait_for_players(sock: RoomSocket, n: int, timeout_s: float = 10.0,
                     server: Optional[RoomServer] = None) -> List[str]:
    """Poll until the room holds ``n`` players (self included) or raise.
    Pass ``server`` to co-drive an in-process RoomServer (tests)."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if server is not None:
            server.poll()
        players = sock.poll_roster()
        if sock.last_reject is not None:
            # the server refused the join (e.g. bad join token): fail fast
            # with the reason instead of spinning until the timeout
            raise PermissionError(
                f"room '{sock.room}' join rejected: {sock.last_reject}"
            )
        if len(players) >= n:
            return players
        time.sleep(0.005)
    raise TimeoutError(
        f"room '{sock.room}' has {len(sock.players())}/{n} players"
    )


def assign_handles(sock: RoomSocket) -> Dict[int, str]:
    """Deterministic handle assignment every peer derives identically:
    sorted peer ids, index = handle (the matchbox-tutorial convention)."""
    return {h: p for h, p in enumerate(sock.players())}
