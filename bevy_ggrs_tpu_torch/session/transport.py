"""Pluggable non-blocking transport.

Mirrors the reference's socket abstraction: a ``NonBlockingSocket`` trait
with a UDP implementation (``UdpNonBlockingSocket::bind_to_port``,
bevy_ggrs tests/p2p.rs:107) and room for alternatives (the reference
supports matchbox WebRTC; here any object with the same two methods works —
e.g. an in-process channel for deterministic tests, or the framed-TCP
transport below for UDP-hostile networks).

A copy of ``bevy_ggrs_tpu/session/transport.py``."""

from __future__ import annotations

import socket
from collections import deque
from typing import Any, List, Protocol, Tuple


class NonBlockingSocket(Protocol):
    """Transport protocol: send_to(data, addr) + receive_all()."""
    def send_to(self, data: bytes, addr: Any) -> None: ...

    def receive_all(self) -> List[Tuple[Any, bytes]]: ...


class UdpNonBlockingSocket:
    """Non-blocking UDP socket bound to a local port."""

    def __init__(self, port: int = 0, host: str = "0.0.0.0"):
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._sock.setblocking(False)
        self._sock.bind((host, port))

    @classmethod
    def bind_to_port(cls, port: int) -> "UdpNonBlockingSocket":
        return cls(port)

    @property
    def local_addr(self) -> Tuple[str, int]:
        return self._sock.getsockname()

    def send_to(self, data: bytes, addr) -> None:
        try:
            self._sock.sendto(data, addr)
        except (BlockingIOError, OSError):
            pass  # non-blocking: drop on full buffer (UDP semantics)

    def receive_all(self) -> List[Tuple[Any, bytes]]:
        """Drain every pending datagram -> [(addr, bytes)]."""
        out = []
        while True:
            try:
                data, addr = self._sock.recvfrom(65536)
            except (BlockingIOError, OSError):
                break
            out.append((addr, data))
        return out

    def close(self) -> None:
        self._sock.close()


class _CorruptStream(Exception):
    """Framing desynchronized — the connection must be torn down."""


class _TcpConn:
    """One TCP connection: frame-aligned send queue + receive buffer.

    The send side queues COMPLETE frames and tracks how many bytes of the
    head frame went out (``sent0``), so a connection handoff can drop the
    partially-transmitted head instead of splicing a frame tail into a
    fresh stream (which would permanently misalign the receiver)."""

    __slots__ = ("sock", "rbuf", "frames", "sent0")

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self.rbuf = bytearray()
        self.frames: deque = deque()  # complete framed byte strings
        self.sent0 = 0  # bytes of frames[0] already transmitted

    def queue(self, framed: bytes) -> None:
        self.frames.append(framed)

    def flush(self) -> bool:
        """Send as much as possible; False if the connection died."""
        while self.frames:
            head = self.frames[0]
            try:
                sent = self.sock.send(
                    head[self.sent0:] if self.sent0 else head
                )
            except (BlockingIOError, InterruptedError):
                return True
            except OSError:
                return False
            self.sent0 += sent
            if self.sent0 < len(head):
                return True
            self.frames.popleft()
            self.sent0 = 0
        return True

    def adopt_queue_from(self, other: "_TcpConn") -> None:
        """Carry over pending frames, dropping a partially-sent head (its
        tail belongs to the dying stream; the datagram is lost — UDP-like)."""
        frames = other.frames
        if other.sent0 and frames:
            frames.popleft()
        self.frames.extend(frames)

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass


class TcpNonBlockingSocket:
    """Second production transport: framed datagrams over non-blocking TCP.

    The reference's drop-in transport alternative is matchbox WebRTC for
    environments where raw UDP is unavailable (bevy_ggrs README.md:79);
    the equivalent niche here is TCP — NAT/firewall-friendly, tunnels over
    SSH/TLS proxies.  Same two-method protocol as UDP, so sessions take it
    unchanged: datagrams are type-tagged, length-prefixed frames on the
    stream; peer addressing stays (host, port) — the LISTENING address of
    each peer, so either side may dial and both directions share one
    connection (the connection initiated by the lower listen address wins a
    simultaneous dial, on both sides).

    Semantics notes: TCP delivers reliably/in-order, which the GGRS protocol
    tolerates (it is loss-tolerant, not loss-requiring); head-of-line
    blocking makes it a worse *competitive* transport than UDP — same
    trade-off the reference accepts for WebRTC data channels in reliable
    mode.

    Peer identity: an inbound connection is keyed by the IP observed on the
    wire (``getpeername``) + the listener port announced in the peer's hello
    frame, so NATed dialers are keyed by their routable return address (the
    one this side's address book dials), not their self-reported private IP.
    Caveat for multi-homed hosts: if the peer's return route uses a
    different interface than the address you dial it at, the keys can still
    disagree — bind each listener to a specific interface (not 0.0.0.0) in
    multi-homed deployments so the simultaneous-dial tie-break is computed
    on the same key by both sides."""

    _MAX_FRAME = 1 << 20
    _DATA = 0x00
    _HELLO = 0x01  # payload = 4-byte IP + 2-byte port of the sender's listener

    def __init__(self, port: int = 0, host: str = "0.0.0.0"):
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))
        self._listener.listen(16)
        self._listener.setblocking(False)
        self._conns: dict = {}  # peer listen-addr -> _TcpConn
        self._pending: List[_TcpConn] = []  # accepted, hello not yet seen

    @classmethod
    def bind_to_port(cls, port: int) -> "TcpNonBlockingSocket":
        return cls(port)

    @property
    def local_addr(self) -> Tuple[str, int]:
        return self._listener.getsockname()

    # -- connection management (all non-blocking) --------------------------

    def _dial(self, addr) -> None:
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.setblocking(False)
        try:
            s.connect(addr)
        except (BlockingIOError, OSError):
            pass  # in progress (EINPROGRESS) or refused; writes will fail
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        conn = _TcpConn(s)
        # announce OUR listen address so the acceptor can key this conn.
        # The IP is this socket's own source address toward the peer (chosen
        # by the kernel at connect time) — a listener bound to 0.0.0.0 has
        # no single IP, but the route to this peer does.
        src_ip = "127.0.0.1"
        try:
            got = s.getsockname()[0]
            if got not in ("0.0.0.0", ""):
                src_ip = got
        except OSError:
            pass
        me = self.local_addr
        ip = me[0] if me[0] != "0.0.0.0" else src_ip
        hello = socket.inet_aton(ip) + me[1].to_bytes(2, "big")
        conn.queue(self._frame(hello, self._HELLO))
        self._conns[tuple(addr)] = conn

    @classmethod
    def _frame(cls, data: bytes, ftype: int = 0x00) -> bytes:
        if len(data) + 1 > cls._MAX_FRAME:
            raise ValueError(
                f"datagram of {len(data)} bytes exceeds the transport's "
                f"{cls._MAX_FRAME - 1}-byte frame limit"
            )
        return (len(data) + 1).to_bytes(4, "big") + bytes([ftype]) + data

    @staticmethod
    def _pump(conn: _TcpConn) -> bool:
        """Read available bytes into the conn's rbuf; False if peer closed."""
        while True:
            try:
                chunk = conn.sock.recv(65536)
            except (BlockingIOError, InterruptedError):
                return True
            except OSError:
                return False
            if not chunk:
                return False
            conn.rbuf.extend(chunk)

    def _pop_frames(self, rbuf: bytearray) -> List[Tuple[int, bytes]]:
        """-> [(frame_type, payload)] for every complete frame in rbuf.

        Raises :class:`_CorruptStream` on an impossible length prefix — the
        stream is misaligned and cannot recover; the caller tears the
        connection down (the next send re-dials)."""
        frames = []
        while len(rbuf) >= 4:
            n = int.from_bytes(rbuf[:4], "big")
            if n < 1 or n > self._MAX_FRAME:
                raise _CorruptStream()
            if len(rbuf) < 4 + n:
                break
            frames.append((rbuf[4], bytes(rbuf[5:4 + n])))
            del rbuf[:4 + n]
        return frames

    def _accept_all(self) -> None:
        while True:
            try:
                s, _ = self._listener.accept()
            except (BlockingIOError, OSError):
                break
            s.setblocking(False)
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._pending.append(_TcpConn(s))

    # -- NonBlockingSocket protocol ----------------------------------------

    def send_to(self, data: bytes, addr) -> None:
        """Queue one datagram to the peer listening at ``addr`` (dials on
        first use; drops the connection on a dead socket so the next send
        re-dials — UDP-like fire-and-forget at the datagram layer)."""
        addr = tuple(addr)
        if addr not in self._conns:
            self._dial(addr)
        conn = self._conns[addr]
        conn.queue(self._frame(data))
        if not conn.flush():
            # connection dead; drop it so the next send re-dials (UDP-like
            # fire-and-forget semantics at the datagram layer)
            conn.close()
            del self._conns[addr]

    def receive_all(self) -> List[Tuple[Any, bytes]]:
        """Drain every complete datagram -> [(peer_listen_addr, bytes)];
        also accepts/promotes inbound connections and flushes send backlogs."""
        self._accept_all()
        out: List[Tuple[Any, bytes]] = []
        # promote pending accepted conns once their hello frame arrives
        still_pending: List[_TcpConn] = []
        me = self.local_addr
        my_key = ("127.0.0.1" if me[0] == "0.0.0.0" else me[0], me[1])
        for conn in self._pending:
            alive = self._pump(conn)
            try:
                frames = self._pop_frames(conn.rbuf)
            except _CorruptStream:
                conn.close()
                continue
            if not frames:
                if alive:
                    still_pending.append(conn)  # hello not complete yet
                else:
                    conn.close()
                continue
            ftype, payload = frames[0]
            if ftype != self._HELLO or len(payload) != 6:
                conn.close()  # protocol violation: first frame must be hello
                continue
            # Key the conn by the peer IP OBSERVED on the wire (getpeername)
            # plus the hello's listener port.  The self-reported hello IP is
            # the kernel-chosen source IP of the dialer's socket, which on
            # NATed hosts is a private address the acceptor cannot dial —
            # the observed address is the routable return path and matches
            # the address book the session dials.  Self-report is only the
            # fallback when the socket cannot name its peer.
            hello_ip = socket.inet_ntoa(payload[:4])
            try:
                observed_ip = conn.sock.getpeername()[0]
            except OSError:
                observed_ip = hello_ip
            if observed_ip in ("", "0.0.0.0"):
                observed_ip = hello_ip
            peer = (observed_ip, int.from_bytes(payload[4:6], "big"))
            data = [p for t, p in frames[1:] if t == self._DATA]
            if peer in self._conns:
                # simultaneous dial: the connection initiated by the LOWER
                # listen address is canonical on both sides
                if my_key < peer:
                    # our own dialed conn wins; drain then drop the inbound
                    out.extend((peer, p) for p in data)
                    conn.close()
                    continue
                old = self._conns[peer]
                conn.adopt_queue_from(old)
                old.close()
                self._conns[peer] = conn
            else:
                self._conns[peer] = conn
            out.extend((peer, p) for p in data)
        self._pending = still_pending
        # established connections: flush backlog, then read
        for addr in list(self._conns):
            conn = self._conns[addr]
            if not conn.flush():
                conn.close()
                del self._conns[addr]
                continue
            alive = self._pump(conn)
            try:
                frames = self._pop_frames(conn.rbuf)
            except _CorruptStream:
                conn.close()
                del self._conns[addr]
                continue
            for ftype, payload in frames:
                if ftype == self._DATA:
                    out.append((addr, payload))
                # helloes on established conns are idempotent re-keys: ignore
            if not alive:
                conn.close()
                del self._conns[addr]
        return out

    def close(self) -> None:
        """Close the listener and every connection."""
        for conn in self._conns.values():
            conn.close()
        for conn in self._pending:
            conn.close()
        self._listener.close()
