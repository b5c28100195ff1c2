"""Fleet control-plane wire protocol — riding the room wire format.

Port of ``bevy_ggrs_tpu/fleet/protocol.py``: host code, copied with
``telemetry`` bound to the port's, so every message is byte for byte the
JAX package's and a port worker can register with a JAX scheduler (and the
other way round).

The fleet messages reuse the room server's framing verbatim (same
``ROOM_MAGIC`` header struct, length-prefixed UTF-8 strings, bail-on-
malformed decoding posture — see session/room.py) so a fleet scheduler can
share ports, parsers, and packet-capture tooling with the signaling plane
it grew out of.  Type bytes 32+ are the fleet range; the room server drops
unknown types on the floor, so the planes can even cohabit one socket.

Message inventory (w = worker, s = scheduler, c = client):

========  =======  ====================================================
type      dir      payload
========  =======  ====================================================
REGISTER  w -> s   worker_id, capacity (u16) — (re-)announce a worker
HEARTBEAT w -> s   worker_id, JSON stats (lobbies, qos, bytes, ratio)
HB_SEQ    w -> s   worker_id, seq (u32), stats digest — liveness-only
                   heartbeat when the stats payload is unchanged (the
                   scheduler refreshes last-seen iff the digest matches
                   the stats it already holds)
PLACE     s -> w   lobby_id, JSON LobbySpec — host this lobby from 0
PLACE_OK  w -> s   lobby_id, frame (u32) — lobby is running
DRAIN     s -> w   lobby_id, barrier frame (u32) — stop AT barrier,
                   checkpoint, ship (the migration drain half)
CKPT      both     lobby_id, frame (u32), seq/total (u16), chunk bytes
                   — chunked checkpoint transfer, reassembled by (lobby,
                   frame); fits any checkpoint through UDP datagrams
CKPT_ACK  s -> w   lobby_id, frame (u32) — stop re-shipping this one
RESUME    s -> w   lobby_id, frame (u32), JSON LobbySpec — expect CKPT
                   chunks for (lobby, frame), restore, run
RESUME_OK w -> s   lobby_id, frame (u32) — restored and running
DROP      s -> w   lobby_id — forget a drained/migrated-away lobby
SUBMIT    c -> s   lobby_id, JSON LobbySpec — request placement
SUBMIT_OK s -> c   lobby_id, worker_id — admitted and placed
REJECT    s -> c   lobby_id, reason — admission refused (wire-visible
                   reason; the room server's join-reject type, reused)
DONE      w -> s   lobby_id, frame (u32), checksum (hex str)
========  =======  ====================================================

Stats/spec payloads are JSON: the control plane is low-rate (heartbeats,
placements), so self-describing beats packed here — the data plane (game
datagrams, checkpoint chunks) stays binary.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import struct
from typing import Any, List, Optional, Tuple

from ..session.room import ROOM_MAGIC, _HDR, _Reader, _pack_str

log = logging.getLogger(__name__)

# peers we have already warned about — the counter keeps counting, the
# log line fires once per peer so a hostile/misconfigured sender cannot
# flood the scheduler's log at datagram rate
_malformed_peers: set = set()


def note_malformed(addr=None) -> None:
    """Account one datagram :func:`decode` dropped (wrong magic, truncated
    fields, bad JSON, unknown type byte — ANY failed decode counts) into
    ``fleet_malformed_datagrams_total`` and warn once per peer.

    Callers pass the ``recvfrom`` address when they have it; a ``None``
    peer is grouped under ``<unknown>``."""
    from .. import telemetry

    telemetry.count(
        "fleet_malformed_datagrams_total",
        help="fleet datagrams dropped by the decoder as malformed or "
             "non-fleet (any failed decode, unknown type bytes included)",
    )
    peer = (
        f"{addr[0]}:{addr[1]}"
        if isinstance(addr, tuple) and len(addr) >= 2
        else "<unknown>"
    )
    if peer not in _malformed_peers:
        _malformed_peers.add(peer)
        log.warning(
            "fleet: dropping malformed datagram(s) from %s (counted in "
            "fleet_malformed_datagrams_total)", peer,
        )

# fleet message range: 32+ (room control types are 1..8)
T_REGISTER = 32
T_HEARTBEAT = 33
T_PLACE = 34
T_PLACE_OK = 35
T_DRAIN = 36
T_CKPT = 37
T_CKPT_ACK = 38
T_RESUME = 39
T_RESUME_OK = 40
T_DROP = 41
T_SUBMIT = 42
T_SUBMIT_OK = 43
T_DONE = 44
T_HEARTBEAT_SEQ = 45
# admission rejects reuse the room server's reject type so a fleet client
# shares the room client's "refused, here is why" handling
T_REJECT = 8

# checkpoint chunk payload size: comfortably under the 65507-byte UDP
# datagram ceiling with header + ids on top, large enough that a small
# lobby ships in a handful of datagrams
CKPT_CHUNK_BYTES = 32 * 1024

# -- checkpoint bursts (the port's senders; the wire is unchanged) -----------
#
# A receiver drains its socket between polls, so a burst of chunks larger
# than its receive buffer keeps only its head.  Sent in one fixed order on
# every re-ship round, the same head would land every time, and a
# checkpoint past the buffer (a 65,536-entity lobby's is ~48 chunks; a
# default 208 KiB loopback buffer holds 6) would never complete.  So each
# re-ship round starts its burst RESHIP_STRIDE chunks further on, and
# successive rounds deliver new chunks.

#: chunks each re-ship round advances its start by: 4 (128 KiB) fit a
#: default 208 KiB loopback receive buffer with room to spare
RESHIP_STRIDE = 4


def reship_order(datagrams: List[bytes], rounds: int) -> List[bytes]:
    """The datagrams of one checkpoint burst in the order of re-ship round
    ``rounds`` (0 = as chunked): rotated ``rounds * RESHIP_STRIDE`` on."""
    if not datagrams:
        return datagrams
    k = (rounds * RESHIP_STRIDE) % len(datagrams)
    return datagrams[k:] + datagrams[:k]


def _pack_u32(v: int) -> bytes:
    return struct.pack("<I", int(v) & 0xFFFFFFFF)


def _pack_u16(v: int) -> bytes:
    return struct.pack("<H", int(v) & 0xFFFF)


def _u32(r: _Reader) -> int:
    d = r.take(4)
    return struct.unpack("<I", d)[0] if r.ok else 0


def _json_str(obj: Any) -> str:
    return json.dumps(obj, separators=(",", ":"), sort_keys=True)


def _pack_json(obj: Any) -> bytes:
    """JSON payloads ride as the datagram tail (no length prefix needed —
    they are always the final field)."""
    return _json_str(obj).encode("utf-8")


def _read_json(r: _Reader) -> Optional[Any]:
    raw = r.rest()
    if not r.ok:
        return None
    try:
        return json.loads(raw.decode("utf-8"))
    except (UnicodeDecodeError, ValueError):
        return None


@dataclasses.dataclass(frozen=True)
class Msg:
    """One decoded fleet datagram.  ``kind`` is the ``T_*`` type byte;
    unused fields stay at their defaults (the decoder only fills what the
    type carries)."""

    kind: int
    a: str = ""          # worker_id / lobby_id (first id field)
    b: str = ""          # second id / reason / checksum-hex
    frame: int = 0
    seq: int = 0
    total: int = 0
    blob: bytes = b""    # checkpoint chunk payload
    obj: Any = None      # decoded JSON payload (stats / spec)


def encode_register(worker_id: str, capacity: int) -> bytes:
    """REGISTER: announce a worker and its lobby capacity."""
    return (_HDR.pack(ROOM_MAGIC, T_REGISTER) + _pack_str(worker_id)
            + _pack_u16(capacity))


def encode_heartbeat(worker_id: str, stats: dict) -> bytes:
    """HEARTBEAT: the worker's live load/QoS report (JSON tail)."""
    return (_HDR.pack(ROOM_MAGIC, T_HEARTBEAT) + _pack_str(worker_id)
            + _pack_json(stats))


def stats_digest(stats: dict) -> str:
    """Canonical digest of a heartbeat stats payload.

    Both ends hash the same canonical JSON (:func:`_json_str` — sorted
    keys, tight separators, round-trip stable for JSON scalars), so the
    worker's digest of what it sent equals the scheduler's digest of what
    it decoded; a HB_SEQ datagram then proves "stats unchanged" without
    re-shipping them."""
    return hashlib.blake2b(
        _json_str(stats).encode("utf-8"), digest_size=8
    ).hexdigest()


def encode_heartbeat_seq(worker_id: str, seq: int, digest: str) -> bytes:
    """HB_SEQ: liveness-only heartbeat — the stats payload is unchanged
    since the last full HEARTBEAT (``digest`` proves which one)."""
    return (_HDR.pack(ROOM_MAGIC, T_HEARTBEAT_SEQ) + _pack_str(worker_id)
            + _pack_u32(seq) + _pack_str(digest))


def encode_place(lobby_id: str, spec: dict) -> bytes:
    """PLACE: host this lobby from frame 0."""
    return (_HDR.pack(ROOM_MAGIC, T_PLACE) + _pack_str(lobby_id)
            + _pack_json(spec))


def encode_place_ok(lobby_id: str, frame: int) -> bytes:
    """PLACE_OK: the lobby is built and running."""
    return (_HDR.pack(ROOM_MAGIC, T_PLACE_OK) + _pack_str(lobby_id)
            + _pack_u32(frame))


def encode_drain(lobby_id: str, barrier_frame: int) -> bytes:
    """DRAIN: advance exactly to ``barrier_frame``, checkpoint, ship."""
    return (_HDR.pack(ROOM_MAGIC, T_DRAIN) + _pack_str(lobby_id)
            + _pack_u32(barrier_frame))


def encode_ckpt_chunk(lobby_id: str, frame: int, seq: int, total: int,
                      chunk: bytes) -> bytes:
    """CKPT: one chunk of a (lobby, frame) checkpoint."""
    return (_HDR.pack(ROOM_MAGIC, T_CKPT) + _pack_str(lobby_id)
            + _pack_u32(frame) + _pack_u16(seq) + _pack_u16(total) + chunk)


def encode_ckpt_ack(lobby_id: str, frame: int) -> bytes:
    """CKPT_ACK: the full (lobby, frame) checkpoint arrived."""
    return (_HDR.pack(ROOM_MAGIC, T_CKPT_ACK) + _pack_str(lobby_id)
            + _pack_u32(frame))


def encode_resume(lobby_id: str, frame: int, spec: dict) -> bytes:
    """RESUME: restore (lobby, frame) from the CKPT chunks that follow."""
    return (_HDR.pack(ROOM_MAGIC, T_RESUME) + _pack_str(lobby_id)
            + _pack_u32(frame) + _pack_json(spec))


def encode_resume_ok(lobby_id: str, frame: int) -> bytes:
    """RESUME_OK: restored at ``frame`` and running."""
    return (_HDR.pack(ROOM_MAGIC, T_RESUME_OK) + _pack_str(lobby_id)
            + _pack_u32(frame))


def encode_drop(lobby_id: str) -> bytes:
    """DROP: forget a lobby (post-migration source cleanup)."""
    return _HDR.pack(ROOM_MAGIC, T_DROP) + _pack_str(lobby_id)


def encode_submit(lobby_id: str, spec: dict) -> bytes:
    """SUBMIT: a client asks the scheduler to place a lobby."""
    return (_HDR.pack(ROOM_MAGIC, T_SUBMIT) + _pack_str(lobby_id)
            + _pack_json(spec))


def encode_submit_ok(lobby_id: str, worker_id: str) -> bytes:
    """SUBMIT_OK: admitted; ``worker_id`` hosts it."""
    return (_HDR.pack(ROOM_MAGIC, T_SUBMIT_OK) + _pack_str(lobby_id)
            + _pack_str(worker_id))


def encode_reject(lobby_id: str, reason: str) -> bytes:
    """REJECT: admission refused, with the wire-visible reason."""
    return (_HDR.pack(ROOM_MAGIC, T_REJECT) + _pack_str(lobby_id)
            + _pack_str(reason))


def encode_done(lobby_id: str, frame: int, checksum_hex: str) -> bytes:
    """DONE: the lobby reached its target frame; final checksum attached."""
    return (_HDR.pack(ROOM_MAGIC, T_DONE) + _pack_str(lobby_id)
            + _pack_u32(frame) + _pack_str(checksum_hex))


def decode(data: bytes) -> Optional[Msg]:
    """Decode one fleet datagram; None for non-fleet or malformed bytes
    (same drop-don't-crash posture as the room decoders — every input is
    untrusted)."""
    if len(data) < _HDR.size:
        return None
    magic, t = _HDR.unpack_from(data)
    if magic != ROOM_MAGIC:
        return None
    r = _Reader(data[_HDR.size:])
    if t == T_REGISTER:
        wid = r.s()
        cap = struct.unpack("<H", r.take(2))[0] if r.ok else 0
        if not r.ok or not wid:
            return None
        return Msg(t, a=wid, total=cap)
    if t == T_HEARTBEAT:
        wid = r.s()
        obj = _read_json(r)
        if not r.ok or not wid or not isinstance(obj, dict):
            return None
        return Msg(t, a=wid, obj=obj)
    if t == T_HEARTBEAT_SEQ:
        wid = r.s()
        seq = _u32(r)
        dig = r.s()
        if not r.ok or not wid or not dig:
            return None
        return Msg(t, a=wid, b=dig, seq=seq)
    if t in (T_PLACE, T_RESUME, T_SUBMIT):
        lid = r.s()
        frame = _u32(r) if t == T_RESUME else 0
        obj = _read_json(r)
        if not r.ok or not lid or not isinstance(obj, dict):
            return None
        return Msg(t, a=lid, frame=frame, obj=obj)
    if t in (T_PLACE_OK, T_RESUME_OK, T_CKPT_ACK, T_DRAIN):
        lid = r.s()
        frame = _u32(r)
        if not r.ok or not lid:
            return None
        return Msg(t, a=lid, frame=frame)
    if t == T_CKPT:
        lid = r.s()
        frame = _u32(r)
        seq = struct.unpack("<H", r.take(2))[0] if r.ok else 0
        total = struct.unpack("<H", r.take(2))[0] if r.ok else 0
        blob = r.rest()
        if not r.ok or not lid or total == 0 or seq >= total:
            return None
        return Msg(t, a=lid, frame=frame, seq=seq, total=total, blob=blob)
    if t == T_DROP:
        lid = r.s()
        if not r.ok or not lid:
            return None
        return Msg(t, a=lid)
    if t in (T_SUBMIT_OK, T_REJECT):
        lid = r.s()
        second = r.s()
        if not r.ok or not lid:
            return None
        return Msg(t, a=lid, b=second)
    if t == T_DONE:
        lid = r.s()
        frame = _u32(r)
        cks = r.s()
        if not r.ok or not lid:
            return None
        return Msg(t, a=lid, frame=frame, b=cks)
    return None


def chunk_checkpoint(lobby_id: str, frame: int, blob: bytes) -> List[bytes]:
    """Split a checkpoint into CKPT datagrams (>= 1 even when empty)."""
    total = max(1, (len(blob) + CKPT_CHUNK_BYTES - 1) // CKPT_CHUNK_BYTES)
    if total > 0xFFFF:
        raise ValueError(
            f"checkpoint of {len(blob)} bytes needs {total} chunks "
            "(u16 ceiling) — raise CKPT_CHUNK_BYTES or compress harder"
        )
    return [
        encode_ckpt_chunk(
            lobby_id, frame, i, total,
            blob[i * CKPT_CHUNK_BYTES:(i + 1) * CKPT_CHUNK_BYTES],
        )
        for i in range(total)
    ]


class ChunkAssembler:
    """Reassembles chunked checkpoints keyed by ``(lobby_id, frame)``.

    Chunks may arrive in any order (UDP); a later frame's first chunk for
    the same lobby drops the stale partial (only one checkpoint per lobby
    is ever in flight from one sender).  ``offer`` returns the complete
    blob exactly once, when the last missing chunk lands."""

    def __init__(self):
        self._parts = {}  # (lobby, frame) -> {seq: bytes}; totals implicit

    def offer(self, msg: Msg) -> Optional[bytes]:
        """Feed one CKPT message; returns the full blob when complete."""
        key = (msg.a, msg.frame)
        # supersede any older in-flight checkpoint for this lobby
        for stale in [k for k in self._parts
                      if k[0] == msg.a and k[1] < msg.frame]:
            del self._parts[stale]
        parts = self._parts.setdefault(key, {})
        parts[msg.seq] = msg.blob
        # completeness by explicit coverage, not count: a malformed sender
        # mixing totals for one key must never KeyError the join
        if any(i not in parts for i in range(msg.total)):
            return None
        del self._parts[key]
        return b"".join(parts[i] for i in range(msg.total))

    def pending(self) -> List[Tuple[str, int]]:
        """Keys of incomplete checkpoints (diagnostics)."""
        return sorted(self._parts)
