"""NativeP2PSession — ctypes binding to the C++ host runtime.

Wraps the C++ core (``native/ggrs_core/ggrs_core.h``) behind the same
session interface the runner consumes as the pure-Python
:class:`~.p2p.P2PSession`, so the two are drop-in interchangeable — and
wire-compatible, a native peer can play a Python peer.  The native core
owns the socket, protocol, input queues, and the advance/rollback decision;
Python only moves request buffers and checksums.

A copy of ``bevy_ggrs_tpu/session/native.py`` (its telemetry call, the
``checksum_mismatch_total{kind=p2p}`` count of a core-detected desync,
included) with its own build: at first use, ``native/ggrs_core/ggrs_core.cc``
is compiled with the flags of ``native/Makefile`` into ``_build/`` beside
this package (listed in ``.gitignore``); nothing is written under
``native/``.
"""

from __future__ import annotations

import ctypes as C
import hashlib
import os
import subprocess
from pathlib import Path
from typing import List, Optional

import numpy as np

from ..telemetry.metrics import registry
from .events import (
    DesyncDetected,
    DesyncDetection,
    Disconnected,
    InvalidRequestError,
    NetworkInterrupted,
    NetworkResumed,
    NetworkStats,
    NotSynchronizedError,
    PlayerType,
    PredictionThresholdError,
    SessionState,
    Synchronized,
    Synchronizing,
)
from .requests import (
    AdvanceRequest,
    LoadRequest,
    RollbackCause,
    SaveCell,
    SaveRequest,
)

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG.parent / "native" / "ggrs_core" / "ggrs_core.cc"
BUILD_DIR = _PKG / "_build"
#: ``native/Makefile``'s ``CXXFLAGS`` and its ``-shared``
CXX_FLAGS = ("-O2", "-fPIC", "-std=c++17", "-Wall", "-Wextra", "-shared")

_OK = 0
_ERR_PREDICTION = -1
_ERR_NOT_SYNC = -2
_ERR_INVALID = -3

_EV_SYNCING, _EV_SYNCED, _EV_DISC, _EV_INT, _EV_RES, _EV_DESYNC = range(6)

_lib: Optional[C.CDLL] = None


def build_library() -> Path:
    """Compile the C++ core unless a build of this exact source, header and
    flags exists in ``_build/``; returns the library's path."""
    header = SOURCE.with_suffix(".h")
    digest = hashlib.sha256(
        SOURCE.read_bytes() + header.read_bytes() + " ".join(CXX_FLAGS).encode()
    ).hexdigest()[:16]
    lib = BUILD_DIR / f"libggrs_core_{digest}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    res = subprocess.run(
        ["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
        capture_output=True, text=True,
    )
    if res.returncode != 0:
        raise RuntimeError(f"g++ failed on {SOURCE.name}:\n{res.stderr}")
    os.replace(tmp, lib)
    return lib


def load_library() -> C.CDLL:
    """Load (building if needed) the C++ core and bind its C API."""
    global _lib
    if _lib is not None:
        return _lib
    lib = C.CDLL(str(build_library()))
    P = C.c_void_p
    lib.ggrs_p2p_create.restype = P
    lib.ggrs_p2p_create.argtypes = [C.c_int, C.c_int, C.c_uint16, C.c_int,
                                    C.c_int, C.c_int, C.c_double, C.c_double]
    lib.ggrs_p2p_add_player.argtypes = [P, C.c_int, C.c_int, C.c_char_p, C.c_uint16]
    lib.ggrs_p2p_start.argtypes = [P]
    lib.ggrs_p2p_destroy.argtypes = [P]
    lib.ggrs_p2p_local_port.restype = C.c_uint16
    lib.ggrs_p2p_local_port.argtypes = [P]
    lib.ggrs_p2p_poll.argtypes = [P]
    lib.ggrs_p2p_state.argtypes = [P]
    lib.ggrs_p2p_add_local_input.argtypes = [P, C.c_int, C.c_char_p]
    lib.ggrs_p2p_advance.argtypes = [P, C.POINTER(C.c_int32), C.c_int,
                                     C.POINTER(C.c_uint8), C.c_int,
                                     C.POINTER(C.c_int), C.POINTER(C.c_int)]
    lib.ggrs_p2p_current_frame.restype = C.c_int32
    lib.ggrs_p2p_current_frame.argtypes = [P]
    lib.ggrs_p2p_confirmed_frame.restype = C.c_int32
    lib.ggrs_p2p_confirmed_frame.argtypes = [P]
    lib.ggrs_p2p_frames_ahead.argtypes = [P]
    lib.ggrs_p2p_max_prediction.argtypes = [P]
    lib.ggrs_p2p_num_players.argtypes = [P]
    lib.ggrs_p2p_local_handles.argtypes = [P, C.POINTER(C.c_int32), C.c_int]
    lib.ggrs_p2p_next_event.argtypes = [P, C.POINTER(C.c_int32),
                                        C.POINTER(C.c_int32), C.POINTER(C.c_uint64),
                                        C.POINTER(C.c_uint64),
                                        C.c_char_p, C.c_int]
    lib.ggrs_p2p_push_checksum.argtypes = [P, C.c_int32, C.c_uint64]
    lib.ggrs_p2p_stats.argtypes = [P, C.c_int, C.POINTER(C.c_double),
                                   C.POINTER(C.c_int), C.POINTER(C.c_double),
                                   C.POINTER(C.c_int), C.POINTER(C.c_int)]
    _bind_spectator(lib)
    _lib = lib
    return lib


def _bind_spectator(lib: C.CDLL) -> None:
    P = C.c_void_p
    lib.ggrs_spectator_create.restype = P
    lib.ggrs_spectator_create.argtypes = [C.c_int, C.c_int, C.c_uint16,
                                          C.c_char_p, C.c_uint16,
                                          C.c_double, C.c_double, C.c_int]
    lib.ggrs_spectator_destroy.argtypes = [P]
    lib.ggrs_spectator_local_port.restype = C.c_uint16
    lib.ggrs_spectator_local_port.argtypes = [P]
    lib.ggrs_spectator_poll.argtypes = [P]
    lib.ggrs_spectator_state.argtypes = [P]
    lib.ggrs_spectator_current_frame.restype = C.c_int32
    lib.ggrs_spectator_current_frame.argtypes = [P]
    lib.ggrs_spectator_frames_behind.restype = C.c_int32
    lib.ggrs_spectator_frames_behind.argtypes = [P]
    lib.ggrs_spectator_advance.argtypes = [P, C.POINTER(C.c_int32), C.c_int,
                                           C.POINTER(C.c_uint8), C.c_int,
                                           C.POINTER(C.c_int), C.POINTER(C.c_int)]
    lib.ggrs_spectator_next_event.argtypes = [P, C.POINTER(C.c_int32),
                                              C.POINTER(C.c_int32),
                                              C.POINTER(C.c_uint64),
                                              C.POINTER(C.c_uint64),
                                              C.c_char_p, C.c_int]


def native_available() -> bool:
    """True if the native core library can be loaded/built."""
    try:
        load_library()
        return True
    except Exception:
        return False


class NativeP2PSession:
    """P2P session backed by the native C++ core (GGRS session surface)."""

    def __init__(
        self,
        num_players: int,
        players,  # List[Player]
        local_port: int = 0,
        input_shape=(),
        input_dtype=np.uint8,
        max_prediction: int = 8,
        input_delay: int = 0,
        desync_detection: DesyncDetection = DesyncDetection.OFF,
        disconnect_timeout_s: float = 2.0,
        disconnect_notify_start_s: float = 0.5,
    ):
        self._lib = load_library()
        self._num_players = num_players
        self.input_shape = tuple(input_shape)
        self.input_dtype = np.dtype(input_dtype)
        self.input_size = int(np.prod(self.input_shape, dtype=int) or 1) * self.input_dtype.itemsize
        self._max_prediction = max_prediction
        self.desync_detection = desync_detection
        interval = desync_detection.interval if desync_detection.enabled else 0
        self._s = self._lib.ggrs_p2p_create(
            num_players, self.input_size, local_port, max_prediction,
            input_delay, interval, disconnect_timeout_s, disconnect_notify_start_s,
        )
        if not self._s:
            raise InvalidRequestError(f"could not bind UDP port {local_port}")
        # remote player handles, for samplers and rollback-cause attribution
        # (the native core does not export per-load blame, so the decode path
        # below blames the unique remote handle when there is exactly one)
        self._remote_handles = sorted(
            p.handle for p in players if p.kind == PlayerType.REMOTE
        )
        for p in players:
            if p.kind == PlayerType.LOCAL:
                rc = self._lib.ggrs_p2p_add_player(self._s, 0, p.handle, None, 0)
            elif p.kind == PlayerType.REMOTE:
                ip, port = p.address
                rc = self._lib.ggrs_p2p_add_player(
                    self._s, 1, p.handle, ip.encode(), int(port)
                )
            else:  # spectator: host streams confirmed all-player inputs
                ip, port = p.address
                rc = self._lib.ggrs_p2p_add_player(
                    self._s, 2, p.handle, ip.encode(), int(port)
                )
            if rc != _OK:
                raise InvalidRequestError(f"add_player failed rc={rc}")
        if self._lib.ggrs_p2p_start(self._s) != _OK:
            raise InvalidRequestError("incomplete player set")
        # request scratch buffers
        self._req_cap = 4096
        self._req_buf = (C.c_int32 * self._req_cap)()
        self._input_cap = 1 << 20
        self._input_buf = (C.c_uint8 * self._input_cap)()
        self._pending_checksums = {}  # frame -> provider
        self.events_buf: List = []

    def __del__(self):
        try:
            if getattr(self, "_s", None):
                self._lib.ggrs_p2p_destroy(self._s)
                self._s = None
        except Exception:
            pass

    # -- GGRS surface --------------------------------------------------------

    def local_port(self) -> int:
        return int(self._lib.ggrs_p2p_local_port(self._s))

    def num_players(self) -> int:
        return self._num_players

    def max_prediction(self) -> int:
        return self._max_prediction

    def confirmed_frame(self) -> int:
        return int(self._lib.ggrs_p2p_confirmed_frame(self._s))

    def current_frame(self) -> int:
        return int(self._lib.ggrs_p2p_current_frame(self._s))

    def frames_ahead(self) -> int:
        return int(self._lib.ggrs_p2p_frames_ahead(self._s))

    def current_state(self) -> SessionState:
        return (
            SessionState.RUNNING
            if self._lib.ggrs_p2p_state(self._s) == 1
            else SessionState.SYNCHRONIZING
        )

    def local_player_handles(self) -> List[int]:
        """Handles owned by this session."""
        buf = (C.c_int32 * self._num_players)()
        n = self._lib.ggrs_p2p_local_handles(self._s, buf, self._num_players)
        return [int(buf[i]) for i in range(n)]

    def remote_player_handles(self) -> List[int]:
        """Handles owned by remote peers, ascending (sampler surface)."""
        return list(self._remote_handles)

    def poll_remote_clients(self) -> None:
        """Drive the native socket/protocol; drain events and checksums."""
        self._lib.ggrs_p2p_poll(self._s)
        self._flush_checksums()
        self._drain_events()

    def add_local_input(self, handle: int, value) -> None:
        """Stage this tick's input for a local handle."""
        raw = np.asarray(value, self.input_dtype).reshape(self.input_shape)
        rc = self._lib.ggrs_p2p_add_local_input(
            self._s, handle, np.ascontiguousarray(raw).tobytes()
        )
        if rc == _ERR_NOT_SYNC:
            raise NotSynchronizedError()
        if rc != _OK:
            raise InvalidRequestError(f"add_local_input rc={rc}")

    def advance_frame(self) -> List:
        """Run the native advance/rollback decision; decode the request stream."""
        # the native core does not export per-rollback blame, so LOAD decode
        # below reconstructs lateness from the pre-advance frame and blames
        # the unique remote handle when there is exactly one
        cur_before = self.current_frame()
        n_req = C.c_int(0)
        n_in = C.c_int(0)
        rc = self._lib.ggrs_p2p_advance(
            self._s, self._req_buf, self._req_cap,
            self._input_buf, self._input_cap, C.byref(n_req), C.byref(n_in),
        )
        if rc == _ERR_PREDICTION:
            raise PredictionThresholdError()
        if rc == _ERR_NOT_SYNC:
            raise NotSynchronizedError()
        if rc != _OK:
            raise InvalidRequestError(f"advance_frame rc={rc}")
        words = np.ctypeslib.as_array(self._req_buf, (n_req.value,))
        ibytes = bytes(bytearray(self._input_buf[: n_in.value]))
        requests: List = []
        i = 0
        off = 0
        P = self._num_players
        row = P * self.input_size
        while i < n_req.value:
            t = int(words[i])
            if t == 0:  # SAVE
                frame = int(words[i + 1])
                requests.append(SaveRequest(frame, SaveCell(self, frame)))
                i += 2
            elif t == 1:  # LOAD
                frame = int(words[i + 1])
                blamed = (
                    self._remote_handles[0]
                    if len(self._remote_handles) == 1
                    else "unknown"
                )
                requests.append(LoadRequest(frame, cause=RollbackCause(
                    handle=blamed, frame=frame,
                    lateness=max(0, cur_before - frame),
                    mismatch=blamed != "unknown",
                    kind="misprediction" if blamed != "unknown" else "unknown",
                )))
                i += 2
            else:  # ADVANCE
                status = np.array(words[i + 2 : i + 2 + P], np.int8)
                chunk = ibytes[off : off + row]
                off += row
                inputs = np.frombuffer(chunk, self.input_dtype).reshape(
                    (P, *self.input_shape)
                )
                requests.append(AdvanceRequest(inputs.copy(), status))
                i += 2 + P
        return requests

    def events(self):
        """Drain pending session events."""
        out, self.events_buf = self.events_buf, []
        return out

    def network_stats(self, handle: int) -> NetworkStats:
        """Ping/queue/kbps/frames-behind for a remote handle.

        Local, unknown, and disconnected handles return a zeroed snapshot
        with ``is_live=False`` instead of raising, so samplers can sweep
        every handle without exception handling."""
        ping = C.c_double(0)
        q = C.c_int(0)
        kbps = C.c_double(0)
        lfb = C.c_int(0)
        rfb = C.c_int(0)
        rc = self._lib.ggrs_p2p_stats(
            self._s, handle, C.byref(ping), C.byref(q), C.byref(kbps),
            C.byref(lfb), C.byref(rfb),
        )
        if rc != _OK:
            return NetworkStats(is_live=False)
        return NetworkStats(
            ping_ms=ping.value, send_queue_len=q.value, kbps_sent=kbps.value,
            local_frames_behind=lfb.value, remote_frames_behind=rfb.value,
        )

    # -- checksum plumbing (desync detection) --------------------------------

    def _on_cell_saved(self, frame: int, provider) -> None:
        if self.desync_detection.enabled and frame % self.desync_detection.interval == 0:
            self._pending_checksums[frame] = provider

    def _flush_checksums(self) -> None:
        if not self.desync_detection.enabled:
            return
        confirmed = self.confirmed_frame()
        for frame in sorted(self._pending_checksums):
            if frame > confirmed:
                break
            provider = self._pending_checksums[frame]
            peek = getattr(provider, "peek", None)
            value = peek() if peek is not None else None
            if peek is not None and value is None:
                if frame > confirmed - self._max_prediction:
                    # async copy still in flight and the frame is well inside
                    # the window — the native core accepts late checksums, so
                    # retry next poll instead of blocking the tick
                    continue
                value = provider()  # leaving the window: force (flush)
            elif peek is None:
                value = provider()
            del self._pending_checksums[frame]
            if value is not None:
                self._lib.ggrs_p2p_push_checksum(self._s, frame, value & (2**64 - 1))

    def _drain_events(self) -> None:
        kind = C.c_int32(0)
        a = C.c_int32(0)
        b = C.c_uint64(0)
        b2 = C.c_uint64(0)
        addr = C.create_string_buffer(64)
        while self._lib.ggrs_p2p_next_event(
            self._s, C.byref(kind), C.byref(a), C.byref(b), C.byref(b2), addr, 64
        ):
            s = addr.value.decode()
            k = kind.value
            if k == _EV_SYNCING:
                self.events_buf.append(Synchronizing(s, int(b.value), a.value))
            elif k == _EV_SYNCED:
                self.events_buf.append(Synchronized(s))
            elif k == _EV_DISC:
                self.events_buf.append(Disconnected(s))
            elif k == _EV_INT:
                self.events_buf.append(NetworkInterrupted(s, a.value))
            elif k == _EV_RES:
                self.events_buf.append(NetworkResumed(s))
            elif k == _EV_DESYNC:
                reg = registry()
                if reg.enabled:
                    reg.counter("checksum_mismatch_total",
                                "frames whose checksums disagreed").inc(kind="p2p")
                self.events_buf.append(
                    DesyncDetected(
                        frame=a.value, local_checksum=int(b2.value),
                        remote_checksum=int(b.value), addr=s,
                    )
                )


class NativeSpectatorSession:
    """Spectator session backed by the C++ core: follows a host's confirmed
    input stream, never predicts (GGRS session surface)."""

    is_spectator = True

    def __init__(
        self,
        num_players: int,
        host_addr,
        local_port: int = 0,
        input_shape=(),
        input_dtype=np.uint8,
        disconnect_timeout_s: float = 2.0,
        disconnect_notify_start_s: float = 0.5,
        catchup_speed: int = 1,
    ):
        self._lib = load_library()
        self._num_players = num_players
        self.input_shape = tuple(input_shape)
        self.input_dtype = np.dtype(input_dtype)
        self.input_size = int(np.prod(self.input_shape, dtype=int) or 1) * self.input_dtype.itemsize
        ip, port = host_addr
        self._s = self._lib.ggrs_spectator_create(
            num_players, self.input_size, local_port, ip.encode(), int(port),
            disconnect_timeout_s, disconnect_notify_start_s, catchup_speed,
        )
        if not self._s:
            raise InvalidRequestError(f"could not bind UDP port {local_port}")
        self._req_cap = 1024
        self._req_buf = (C.c_int32 * self._req_cap)()
        self._input_cap = 1 << 18
        self._input_buf = (C.c_uint8 * self._input_cap)()
        self.events_buf: List = []

    def __del__(self):
        try:
            if getattr(self, "_s", None):
                self._lib.ggrs_spectator_destroy(self._s)
                self._s = None
        except Exception:
            pass

    def local_port(self) -> int:
        """Bound UDP port (useful with port 0 auto-assignment)."""
        return int(self._lib.ggrs_spectator_local_port(self._s))

    def num_players(self) -> int:
        return self._num_players

    def max_prediction(self) -> int:
        return 0  # spectators never predict

    def confirmed_frame(self) -> int:
        return self.current_frame() - 1

    def current_frame(self) -> int:
        """Next frame to replay."""
        return int(self._lib.ggrs_spectator_current_frame(self._s))

    def frames_behind_host(self) -> int:
        """How far the host's confirmed stream is ahead of us."""
        return int(self._lib.ggrs_spectator_frames_behind(self._s))

    def current_state(self) -> SessionState:
        return (
            SessionState.RUNNING
            if self._lib.ggrs_spectator_state(self._s) == 1
            else SessionState.SYNCHRONIZING
        )

    def poll_remote_clients(self) -> None:
        """Drive the native socket/protocol; drain events."""
        self._lib.ggrs_spectator_poll(self._s)
        self._drain_events()

    def advance_frame(self) -> List:
        """Replay the next confirmed frame(s) from the host stream."""
        n_req = C.c_int(0)
        n_in = C.c_int(0)
        rc = self._lib.ggrs_spectator_advance(
            self._s, self._req_buf, self._req_cap,
            self._input_buf, self._input_cap, C.byref(n_req), C.byref(n_in),
        )
        if rc == _ERR_PREDICTION:
            raise PredictionThresholdError()
        if rc == _ERR_NOT_SYNC:
            raise NotSynchronizedError()
        if rc != _OK:
            raise InvalidRequestError(f"spectator advance rc={rc}")
        words = np.ctypeslib.as_array(self._req_buf, (n_req.value,))
        ibytes = bytes(bytearray(self._input_buf[: n_in.value]))
        P = self._num_players
        row = P * self.input_size
        requests: List = []
        i = 0
        off = 0
        while i < n_req.value:
            status = np.array(words[i + 2 : i + 2 + P], np.int8)
            chunk = ibytes[off : off + row]
            off += row
            inputs = np.frombuffer(chunk, self.input_dtype).reshape(
                (P, *self.input_shape)
            )
            requests.append(AdvanceRequest(inputs.copy(), status))
            i += 2 + P
        return requests

    def events(self):
        """Drain pending session events."""
        out, self.events_buf = self.events_buf, []
        return out

    def _drain_events(self) -> None:
        kind = C.c_int32(0)
        a = C.c_int32(0)
        b = C.c_uint64(0)
        b2 = C.c_uint64(0)
        addr = C.create_string_buffer(64)
        while self._lib.ggrs_spectator_next_event(
            self._s, C.byref(kind), C.byref(a), C.byref(b), C.byref(b2), addr, 64
        ):
            s = addr.value.decode()
            k = kind.value
            if k == _EV_SYNCING:
                self.events_buf.append(Synchronizing(s, int(b.value), a.value))
            elif k == _EV_SYNCED:
                self.events_buf.append(Synchronized(s))
            elif k == _EV_DISC:
                self.events_buf.append(Disconnected(s))
            elif k == _EV_INT:
                self.events_buf.append(NetworkInterrupted(s, a.value))
            elif k == _EV_RES:
                self.events_buf.append(NetworkResumed(s))
