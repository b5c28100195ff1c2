"""Wire protocol + per-peer endpoint state machine.

The network core hidden behind ``poll_remote_clients``/``advance_frame`` in
the reference's ggrs dependency (SURVEY §5.8): non-blocking UDP, poll-driven,
with sync handshake, redundant input packets, input acks, quality
reports (ping + frame advantage), keepalives, disconnect detection, and
desync-detection checksum reports.

The byte format is little-endian and fixed (shared with the native C++ core
in native/ggrs_core — keep in sync with message.h):

    header:  magic:u16  type:u8
    SYNC_REQ   nonce:u32 version:u8
    SYNC_REP   nonce:u32 version:u8
               (version gates the handshake: mismatched or missing version
               gets no reply, so mixed-version pairs stall in SYNCHRONIZING
               instead of mis-parsing each other's streams)
    INPUT      start_frame:i32 count:u16 ack_frame:i32 advantage:i8
               stream_base:i32 payload: count * input_size bytes
               (stream_base = sender's first-ever input frame: lets a
               receiver anchor its contiguous-ack mark even if the earliest
               packets were lost)
    INPUT_ACK  ack_frame:i32
    QUAL_REQ   ping_ts_us:u64 advantage:i8
    QUAL_REP   pong_ts_us:u64
    KEEP_ALIVE (empty)
    CHECKSUM   frame:i32 checksum:u64
    DISC_NOTICE handle:i16 frame:i32  (disconnect-frame consensus,
               implemented by BOTH cores; peers lacking the message type
               ignore it and keep local-knowledge disconnect semantics)

A copy of ``bevy_ggrs_tpu/session/protocol.py``: the format, the timers and
the constants are the same byte for byte, so a port peer plays a JAX peer
or a native one.  A sync message dropped for its protocol version is logged
and counted (``handshake_version_mismatch_total{remote_version}``).
"""

from __future__ import annotations

import logging
import struct
import time
from typing import Callable, List, Optional, Tuple

import numpy as np

from ..telemetry.metrics import registry
from ..utils.frames import NULL_FRAME, frame_gt
from .events import (
    Disconnected,
    NetworkInterrupted,
    NetworkResumed,
    SessionState,
    Synchronized,
    Synchronizing,
    NetworkStats,
)
from .time_sync import TimeSync

logger = logging.getLogger("bevy_ggrs_tpu_torch")

MAGIC = 0x47A7  # "GGRS-TPU"
HDR = struct.Struct("<HB")

T_SYNC_REQ = 1
T_SYNC_REP = 2
T_INPUT = 3
T_INPUT_ACK = 4
T_QUAL_REQ = 5
T_QUAL_REP = 6
T_KEEP_ALIVE = 7
T_CHECKSUM = 8
# disconnect-frame consensus (GGPO-style): when a peer drops a player, it
# announces the last frame it holds a REAL input for; every survivor adopts
# the MINIMUM announced frame so they all bake identical inputs for the dead
# player (without this, survivors that received different amounts of the
# dying peer's stream diverge permanently)
T_DISC_NOTICE = 9

# Wire protocol version, carried in the sync handshake (REQ and REP both
# append version:u8 after the nonce).  A peer speaking a different version —
# or a pre-versioning build whose sync messages are 4 bytes — never gets a
# valid reply, so the pair stalls in SYNCHRONIZING instead of mis-parsing
# each other's input rows mid-game.  Bump on ANY wire-format change (shared
# with native/ggrs_core/ggrs_core.cc — keep in sync).
PROTOCOL_VERSION = 1

S_SYNC_REQ = struct.Struct("<IB")
S_SYNC_REP = struct.Struct("<IB")
_S_SYNC_NONCE = struct.Struct("<I")  # the pre-version prefix
S_INPUT = struct.Struct("<iHibi")
S_INPUT_ACK = struct.Struct("<i")
S_QUAL_REQ = struct.Struct("<Qb")
S_QUAL_REP = struct.Struct("<Q")
S_CHECKSUM = struct.Struct("<iQ")
S_DISC_NOTICE = struct.Struct("<hi")  # (player handle, disconnect frame)

NUM_SYNC_ROUNDTRIPS = 5
SYNC_RETRY_S = 0.06
QUALITY_INTERVAL_S = 0.2
KEEP_ALIVE_S = 0.2
# max contribution of a single inter-poll gap to the attended-quiet clock
# (see PeerEndpoint.__init__ — bounds how much remote silence a host stall
# can fabricate)
ATTENDED_GAP_CAP_S = 0.25
MAX_INPUTS_PER_PACKET = 64


def now_s() -> float:
    """Monotonic seconds (protocol timer clock)."""
    return time.monotonic()


class PeerEndpoint:
    """Protocol state machine for one remote peer address.

    Handles sync, input exchange (with redundancy + ack), quality/ping,
    keepalive/disconnect and checksum reports.  Transport-agnostic: ``send``
    is a callable taking raw bytes."""

    def __init__(
        self,
        send: Callable[[bytes], None],
        input_size: int,
        rng_nonce: int,
        disconnect_timeout_s: float = 2.0,
        disconnect_notify_start_s: float = 0.5,
        addr=None,
    ):
        self.send_raw = send
        self.addr = addr
        self.input_size = input_size
        self.state = SessionState.SYNCHRONIZING
        self._sync_nonce = rng_nonce & 0xFFFFFFFF
        self._sync_remaining = NUM_SYNC_ROUNDTRIPS
        self._last_sync_sent = 0.0
        self.disconnect_timeout_s = disconnect_timeout_s
        self.disconnect_notify_start_s = disconnect_notify_start_s
        self._last_recv = now_s()
        # attended-quiet accounting: remote silence only counts toward the
        # disconnect timeout while the host was actually polling.  Each
        # inter-poll gap contributes at most ATTENDED_GAP_CAP_S, so a host
        # stall (XLA compile of a new program variant, GC pause, debugger)
        # does not read as seconds of remote silence and spuriously drop a
        # live peer.  A genuinely dead peer still times out after
        # ``disconnect_timeout_s`` of attended silence.
        self._quiet_s = 0.0
        self._last_poll = now_s()
        self._last_send = 0.0
        self._last_quality_sent = 0.0
        self.interrupted = False
        self.disconnected = False
        self.events: List = []
        self.time_sync = TimeSync()
        # input plumbing (frames are EFFECTIVE frames, delay already applied)
        self.last_acked = NULL_FRAME  # newest of our inputs the peer has
        self.last_received_frame = NULL_FRAME  # newest peer input we have (max)
        # highest CONTIGUOUSLY received frame — what we ack (acking the max
        # across a chunk-loss gap would stop the sender refilling the gap)
        self.contig_received = NULL_FRAME
        self._contig_anchored = False  # contig holds a real value (it can
        # legitimately be -1 when the peer's stream starts at frame 0)
        self.stream_base = None  # first frame of OUR outbound input stream
        self.on_input: Optional[Callable[[int, bytes], None]] = None
        self.on_stream_base: Optional[Callable[[int], None]] = None
        self.on_checksum: Optional[Callable[[int, int], None]] = None
        self.on_disc_notice: Optional[Callable[[int, int], None]] = None
        self.local_advantage = 0  # set by session before poll
        # stats
        self.ping_s = 0.0
        self.bytes_sent = 0
        self._created = now_s()
        self.send_queue_len = 0
        self.remote_advantage = 0

    # -- sending ------------------------------------------------------------

    def _send(self, t: int, body: bytes = b"") -> None:
        data = HDR.pack(MAGIC, t) + body
        self.bytes_sent += len(data)
        self._last_send = now_s()
        self.send_raw(data)

    def send_inputs(self, pending: List[Tuple[int, bytes]]) -> None:
        """Send all un-acked inputs (redundant packets, chunked).  ``pending``
        is an ascending [(effective_frame, raw_bytes)] list.  Chunking (up to
        4 packets per call) keeps slow receivers — late-joining or lossy
        spectators — from ever seeing a truncation gap they cannot fill."""
        if self.stream_base is None and pending:
            self.stream_base = pending[0][0]
        pending = [p for p in pending if frame_gt(p[0], self.last_acked)]
        self.send_queue_len = len(pending)
        if not pending:
            return
        for c in range(0, min(len(pending), 4 * MAX_INPUTS_PER_PACKET),
                       MAX_INPUTS_PER_PACKET):
            chunk = pending[c:c + MAX_INPUTS_PER_PACKET]
            body = S_INPUT.pack(
                chunk[0][0], len(chunk), self.contig_received,
                int(np.clip(self.local_advantage, -127, 127)),
                self.stream_base,
            )
            body += b"".join(p[1] for p in chunk)
            self._send(T_INPUT, body)

    def send_input_ack(self) -> None:
        self._send(T_INPUT_ACK, S_INPUT_ACK.pack(self.contig_received))

    def send_checksum(self, frame: int, checksum: int) -> None:
        self._send(T_CHECKSUM, S_CHECKSUM.pack(frame, checksum & (2**64 - 1)))

    def send_disc_notice(self, handle: int, frame: int) -> None:
        self._send(T_DISC_NOTICE, S_DISC_NOTICE.pack(handle, frame))

    # -- receiving ----------------------------------------------------------

    def _sync_version_ok(self, body: bytes) -> bool:
        """Validate the version byte of a sync message body.

        Missing (pre-versioning 4-byte message) or mismatched versions fail;
        the caller drops the packet without replying, stalling the
        handshake."""
        if len(body) < S_SYNC_REQ.size:
            ver = None  # pre-versioning peer
        else:
            ver = body[_S_SYNC_NONCE.size]
        if ver == PROTOCOL_VERSION:
            return True
        reg = registry()
        if reg.enabled:
            reg.counter(
                "handshake_version_mismatch_total",
                "sync messages dropped for a wrong/missing protocol version",
            ).inc(remote_version=("none" if ver is None else ver))
        logger.debug(
            "dropping sync message from %s: protocol version %s != %d",
            self.addr, ver, PROTOCOL_VERSION,
        )
        return False

    def handle(self, data: bytes) -> None:
        """Feed one raw datagram through the protocol state machine
        (untrusted input: malformed packets are dropped)."""
        if self.disconnected:
            # once disconnected, always disconnected (ggrs semantics): a late
            # packet from a dropped peer must not mutate input queues — the
            # session may have advanced its confirmed frame past rollback
            # range on the strength of the disconnect
            return
        try:
            self._handle(data)
        except struct.error:
            return  # truncated/malformed packet: drop (UDP is untrusted input)

    def _handle(self, data: bytes) -> None:
        if len(data) < HDR.size:
            return
        magic, t = HDR.unpack_from(data)
        if magic != MAGIC:
            return
        body = data[HDR.size:]
        was_quiet = self.interrupted
        self._last_recv = now_s()
        self._quiet_s = 0.0
        self._last_poll = self._last_recv  # the gap ending here held a packet
        if self.interrupted:
            self.interrupted = False
            self.events.append(NetworkResumed(self.addr))
        if t == T_SYNC_REQ:
            if not self._sync_version_ok(body):
                return  # no reply: a mixed-version pair must stall, not run
            (nonce, _ver) = S_SYNC_REQ.unpack_from(body)
            self._send(T_SYNC_REP, S_SYNC_REP.pack(nonce, PROTOCOL_VERSION))
        elif t == T_SYNC_REP:
            if not self._sync_version_ok(body):
                return
            (nonce, _ver) = S_SYNC_REP.unpack_from(body)
            if self.state == SessionState.SYNCHRONIZING and nonce == self._sync_nonce:
                self._sync_remaining -= 1
                self._sync_nonce = (self._sync_nonce * 6364136223846793005 + 1) & 0xFFFFFFFF
                self.events.append(
                    Synchronizing(
                        self.addr,
                        NUM_SYNC_ROUNDTRIPS,
                        NUM_SYNC_ROUNDTRIPS - self._sync_remaining,
                    )
                )
                if self._sync_remaining <= 0:
                    self.state = SessionState.RUNNING
                    self.events.append(Synchronized(self.addr))
                else:
                    # continue the handshake immediately (RTT-bound, not
                    # retry-timer-bound); the timer only covers loss
                    self._last_sync_sent = now_s()
                    self._send(
                        T_SYNC_REQ,
                        S_SYNC_REQ.pack(self._sync_nonce, PROTOCOL_VERSION),
                    )
        elif t == T_INPUT:
            start, count, ack, adv, base = S_INPUT.unpack_from(body)
            self._note_ack(ack)
            self.time_sync.note_remote(adv)
            self.remote_advantage = adv
            if not self._contig_anchored:
                # anchor just below the peer's first-ever frame so only
                # ranges connected to the true stream start advance the ack
                self._contig_anchored = True
                self.contig_received = base - 1
                if self.on_stream_base:
                    self.on_stream_base(base)
            payload = body[S_INPUT.size:]
            end = NULL_FRAME
            for i in range(count):
                f = start + i
                raw = payload[i * self.input_size:(i + 1) * self.input_size]
                if len(raw) < self.input_size:
                    break
                end = f
                if frame_gt(f, self.contig_received):
                    if self.last_received_frame == NULL_FRAME or frame_gt(
                        f, self.last_received_frame
                    ):
                        self.last_received_frame = f
                    if self.on_input:
                        self.on_input(f, raw)
            # packets are contiguous ranges: extend the contiguous mark only
            # if this range connects to it
            if (
                end != NULL_FRAME
                and not frame_gt(start, self.contig_received + 1)
                and frame_gt(end, self.contig_received)
            ):
                self.contig_received = end
        elif t == T_INPUT_ACK:
            (ack,) = S_INPUT_ACK.unpack_from(body)
            self._note_ack(ack)
        elif t == T_QUAL_REQ:
            ts, adv = S_QUAL_REQ.unpack_from(body)
            self.time_sync.note_remote(adv)
            self.remote_advantage = adv
            self._send(T_QUAL_REP, S_QUAL_REP.pack(ts))
        elif t == T_QUAL_REP:
            (ts,) = S_QUAL_REP.unpack_from(body)
            self.ping_s = max(0.0, now_s() - ts / 1e6)
        elif t == T_CHECKSUM:
            frame, checksum = S_CHECKSUM.unpack_from(body)
            if self.on_checksum:
                self.on_checksum(frame, checksum)
        elif t == T_DISC_NOTICE:
            handle, frame = S_DISC_NOTICE.unpack_from(body)
            if self.on_disc_notice:
                self.on_disc_notice(handle, frame)
        # T_KEEP_ALIVE: recv timestamp update is enough

    def _note_ack(self, ack: int) -> None:
        if ack != NULL_FRAME and (
            self.last_acked == NULL_FRAME or frame_gt(ack, self.last_acked)
        ):
            self.last_acked = ack

    # -- periodic driving ---------------------------------------------------

    def poll(self) -> None:
        """Advance timers: sync retries, quality reports, keepalive,
        disconnect detection."""
        t = now_s()
        gap = max(t - self._last_poll, 0.0)
        self._last_poll = t
        if self.disconnected:
            return
        # silence accrues per attended poll, capped per gap: a multi-second
        # host stall (e.g. jit compile of a new resim variant) contributes at
        # most ATTENDED_GAP_CAP_S — and never more than half the timeout, so
        # no single stall can trip even an aggressively short timeout
        self._quiet_s += min(
            gap, ATTENDED_GAP_CAP_S, 0.5 * self.disconnect_timeout_s
        )
        if self.state == SessionState.SYNCHRONIZING:
            if t - self._last_sync_sent >= SYNC_RETRY_S:
                self._last_sync_sent = t
                self._send(
                    T_SYNC_REQ,
                    S_SYNC_REQ.pack(self._sync_nonce, PROTOCOL_VERSION),
                )
            return
        if t - self._last_quality_sent >= QUALITY_INTERVAL_S:
            self._last_quality_sent = t
            self._send(
                T_QUAL_REQ,
                S_QUAL_REQ.pack(
                    int(t * 1e6), int(np.clip(self.local_advantage, -127, 127))
                ),
            )
        if t - self._last_send >= KEEP_ALIVE_S:
            # keepalives double as input acks: a stalled peer that sends no
            # INPUT packets must still acknowledge what it received
            if self.last_received_frame != NULL_FRAME:
                self.send_input_ack()
            else:
                self._send(T_KEEP_ALIVE)
        quiet = self._quiet_s
        if quiet >= self.disconnect_timeout_s:
            self.disconnected = True
            self.events.append(Disconnected(self.addr))
        elif quiet >= self.disconnect_notify_start_s and not self.interrupted:
            self.interrupted = True
            self.events.append(
                NetworkInterrupted(
                    self.addr, int(self.disconnect_timeout_s * 1000)
                )
            )

    def stats(self) -> NetworkStats:
        """NetworkStats snapshot for this endpoint."""
        elapsed = max(now_s() - self._created, 1e-6)
        return NetworkStats(
            ping_ms=self.ping_s * 1e3,
            send_queue_len=self.send_queue_len,
            kbps_sent=self.bytes_sent * 8 / 1000 / elapsed,
            local_frames_behind=-self.time_sync.local_advantage(),
            remote_frames_behind=-self.remote_advantage,
        )
