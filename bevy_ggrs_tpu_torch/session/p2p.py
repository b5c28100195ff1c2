"""P2PSession — rollback netcode over a non-blocking socket.

The ggrs-core P2P surface reconstructed in SURVEY §2.3:
``poll_remote_clients`` drains the socket and drives per-peer protocol state;
``advance_frame`` decides save/rollback/advance and returns the request
stream; ``frames_ahead`` drives run-slow; events surface network lifecycle
and desyncs.  Frame semantics: the input added at frame f (after input
delay) governs the f -> f+1 transition; a mispredicted remote input at frame
F invalidates states > F, so the session requests Load(F) then
(Advance, Save) x (current - F) — which the runner serves with one resim
call (docs/architecture.md:21 request shapes).

A copy of ``bevy_ggrs_tpu/session/p2p.py``: the frame semantics, wire
rows, timers and telemetry records are the reference's (the ``input_send``
timeline event a merged Chrome trace links a remote rollback to, and
``checksum_mismatch_total{kind=p2p}``), each behind one boolean check while
telemetry is off."""

from __future__ import annotations

import random
from typing import Any, Dict, List, Tuple

import numpy as np

from ..telemetry.timeline import record as _record_event
from ..telemetry.metrics import registry as _registry
from ..utils.frames import (
    NULL_FRAME,
    frame_add,
    frame_diff,
    frame_ge,
    frame_gt,
    frame_le,
    frame_lt,
    frame_min,
)
from .events import (
    DesyncDetected,
    DesyncDetection,
    Disconnected,
    InputStatus,
    InvalidRequestError,
    NetworkStats,
    NotSynchronizedError,
    Player,
    PlayerType,
    PredictionThresholdError,
    SessionState,
)
from .input_queue import InputQueue
from .protocol import PeerEndpoint, now_s
from .requests import (
    AdvanceRequest,
    LoadRequest,
    RollbackCause,
    SaveCell,
    SaveRequest,
)


# absolute bound on un-acked send history (frames; ~68 s at 60 fps).  The
# ack-driven trim below normally keeps these lists tiny, and a peer that acks
# nothing eventually hits the disconnect timeout — but a peer whose
# *keepalives* arrive while its acks are lost one-way would otherwise defeat
# that timeout and grow the history without bound.  Oldest frames drop first;
# a peer that far behind has lost the stream anyway.
MAX_UNACKED_FRAMES = 4096
# how long an adopted disconnect-consensus frame keeps rebroadcasting
# (notices ride lossy transports; receipt is idempotent under the min rule)
DISC_NOTICE_REBROADCAST_S = 1.5


_REG = _registry()

def _min_ack(endpoints):
    """Oldest last-acked frame across CONNECTED endpoints.

    Returns ``None`` when no connected endpoint remains (pending history can
    be dropped entirely), ``NULL_FRAME`` when some connected endpoint has not
    acked anything yet (nothing may be trimmed — a still-syncing peer or
    spectator must be able to receive the stream from its base), else the
    wraparound-safe minimum ack."""
    acked = None
    for ep in endpoints:
        if ep.disconnected:
            continue
        if ep.last_acked == NULL_FRAME:
            return NULL_FRAME
        acked = ep.last_acked if acked is None else frame_min(acked, ep.last_acked)
    return acked


class P2PSession:
    """Python-core P2P session (see module docstring for semantics)."""
    def __init__(
        self,
        num_players: int,
        players: List[Player],
        socket,
        input_shape=(),
        input_dtype=np.uint8,
        max_prediction: int = 8,
        input_delay: int = 0,
        desync_detection: DesyncDetection = DesyncDetection.OFF,
        disconnect_timeout_s: float = 2.0,
        disconnect_notify_start_s: float = 0.5,
        input_predictor=None,
        eager_checksums: bool = False,
    ):
        self._num_players = num_players
        self.socket = socket
        self.input_shape = tuple(input_shape)
        self.input_dtype = np.dtype(input_dtype)
        self.input_size = int(np.prod(self.input_shape, dtype=int) or 1) * self.input_dtype.itemsize
        self._max_prediction = max_prediction
        self.input_delay = input_delay
        self.desync_detection = desync_detection
        # eager_checksums=True forces every local checksum provider at the
        # tick its frame confirms (the pre-pipeline synchronous behavior;
        # the bench's sync baseline).  Default off: providers are peeked
        # non-blocking each poll and published once the async device->host
        # copy lands — the protocol already tolerates checksums arriving
        # k frames late (docs/architecture.md "Tick pipeline").
        self.eager_checksums = bool(eager_checksums)
        self.current_frame = 0
        self._confirmed = NULL_FRAME
        self.events_buf: List = []
        self._staged: Dict[int, np.ndarray] = {}
        self._disc_corrected: set = set()  # addrs whose disconnect was resolved
        # disconnect-frame consensus (GGPO-style): handle -> last frame whose
        # REAL input stays in the sim; later frames bake DISCONNECTED/zero.
        # Adopted as the MINIMUM of local knowledge and every received
        # T_DISC_NOTICE so all survivors bake identical inputs for the dead
        # player.  _disc_notices rebroadcasts our adopted value for a short
        # window (notices ride lossy transports).
        self._disc_frame: Dict[int, int] = {}
        self._disc_notices: Dict[int, tuple] = {}  # handle -> (frame, until)

        self.local_handles: List[int] = []
        self.remote_handle_addr: Dict[int, Any] = {}
        self.spectator_addrs: List[Any] = []
        for p in players:
            if p.kind == PlayerType.LOCAL:
                self.local_handles.append(p.handle)
            elif p.kind == PlayerType.REMOTE:
                self.remote_handle_addr[p.handle] = p.address
            else:
                self.spectator_addrs.append(p.address)
        # wire rows pack local inputs in ascending-handle order and the
        # receiver unpacks the same way — sort so add_player order is free
        self.local_handles.sort()

        self.queues: Dict[int, InputQueue] = {
            h: InputQueue(self.input_shape, self.input_dtype,
                          delay=input_delay if h in self.local_handles else 0,
                          predictor=input_predictor)
            for h in range(num_players)
        }

        self._handle_of_addr: Dict[Any, List[int]] = {}
        for h, a in self.remote_handle_addr.items():
            self._handle_of_addr.setdefault(a, []).append(h)
        for a in self._handle_of_addr:
            self._handle_of_addr[a].sort()

        self.endpoints: Dict[Any, PeerEndpoint] = {}
        # handshake nonce — MUST differ across processes so a restarted peer
        # at the same addr is detected; host-side protocol state only, never
        # enters the simulation
        rng = random.Random(id(self) ^ random.getrandbits(32))
        peer_addrs = sorted(
            {a for a in self.remote_handle_addr.values()}, key=repr
        )
        for addr in peer_addrs:
            ep = PeerEndpoint(
                send=(lambda data, a=addr: self.socket.send_to(data, a)),
                # the peer streams THEIR local inputs: one row per handle they own
                input_size=self.input_size * len(self._handle_of_addr[addr]),
                rng_nonce=rng.getrandbits(32),
                disconnect_timeout_s=disconnect_timeout_s,
                disconnect_notify_start_s=disconnect_notify_start_s,
                addr=addr,
            )
            ep.on_input = self._make_on_input(addr)
            ep.on_checksum = self._make_on_checksum(addr)
            ep.on_stream_base = self._make_on_stream_base(addr)
            ep.on_disc_notice = self._make_on_disc_notice(addr)
            self.endpoints[addr] = ep
        # spectator endpoints: we stream all-player confirmed inputs to them
        self.spectator_endpoints: Dict[Any, PeerEndpoint] = {}
        for addr in self.spectator_addrs:
            ep = PeerEndpoint(
                send=(lambda data, a=addr: self.socket.send_to(data, a)),
                # full row: all-player inputs + one status byte per player
                input_size=self.input_size * num_players + num_players,
                rng_nonce=rng.getrandbits(32),
                disconnect_timeout_s=disconnect_timeout_s,
                disconnect_notify_start_s=disconnect_notify_start_s,
                addr=addr,
            )
            self.spectator_endpoints[addr] = ep
        # local input bytes pending ack, per remote peer: [(frame, bytes)]
        self._local_sent: List[Tuple[int, bytes]] = []
        # confirmed-input packets pending for spectators
        self._spectator_sent: List[Tuple[int, bytes]] = []
        self._next_spectator_frame = 0
        # desync bookkeeping: frame -> checksum provider / forced value
        self._local_checksums: Dict[int, Any] = {}
        self._remote_checksums: Dict[Tuple[Any, int], int] = {}

    # -- GGRS session surface ----------------------------------------------

    def num_players(self) -> int:
        return self._num_players

    def max_prediction(self) -> int:
        return self._max_prediction

    def rollback_window(self) -> int:
        """Deepest rollback this session can request (= the prediction
        window: a misprediction older than it would have stalled first)."""
        return self._max_prediction

    def confirmed_frame(self) -> int:
        return self._confirmed

    def local_player_handles(self) -> List[int]:
        return list(self.local_handles)

    def current_state(self) -> SessionState:
        """SYNCHRONIZING until every connected endpoint finished its handshake."""
        eps = list(self.endpoints.values()) + list(self.spectator_endpoints.values())
        if all(ep.state == SessionState.RUNNING or ep.disconnected for ep in eps):
            return SessionState.RUNNING
        return SessionState.SYNCHRONIZING

    def frames_ahead(self) -> int:
        """Smoothed frames-ahead estimate driving run-slow.

        Endpoints still warming up contribute 0: run-slow must not chase
        the one-sided seed estimate (half local-only data)."""
        vals = [
            ep.time_sync.frames_ahead()
            for ep in self.endpoints.values()
            if not ep.disconnected and ep.time_sync.warmed_up()
        ]
        return max(vals) if vals else 0

    def events(self):
        """Drain pending session events."""
        out, self.events_buf = self.events_buf, []
        return out

    def remote_player_handles(self) -> List[int]:
        """Handles owned by remote peers, ascending."""
        return sorted(self.remote_handle_addr)

    def network_stats(self, handle: int) -> NetworkStats:
        """Ping/queue/kbps/frames-behind for a remote handle.

        Local, unknown, spectator, and disconnected handles return a zeroed
        snapshot with ``is_live=False`` instead of raising, so periodic
        samplers can walk every handle without exception churn or log spam."""
        addr = self.remote_handle_addr.get(handle)
        if addr is None or addr not in self.endpoints:
            return NetworkStats(is_live=False)
        ep = self.endpoints[addr]
        if ep.disconnected:
            return NetworkStats(is_live=False)
        return ep.stats()

    def time_sync_for(self, handle: int):
        """The :class:`~.time_sync.TimeSync` tracker behind a remote
        handle, or None for non-live handles."""
        addr = self.remote_handle_addr.get(handle)
        if addr is None or addr not in self.endpoints:
            return None
        ep = self.endpoints[addr]
        return None if ep.disconnected else ep.time_sync

    # -- polling ------------------------------------------------------------

    def poll_remote_clients(self) -> None:
        """Drain the socket, drive protocol timers, surface events
        (the process/network boundary, SURVEY §3.1)."""
        for addr, data in self.socket.receive_all():
            ep = self.endpoints.get(addr) or self.spectator_endpoints.get(addr)
            if ep is not None:
                ep.handle(data)
        all_eps = list(self.endpoints.values()) + list(self.spectator_endpoints.values())
        for ep in all_eps:
            ep.local_advantage = self._local_advantage(ep)
            ep.poll()
            self.events_buf.extend(ep.events)
            ep.events.clear()
        for addr, ep in self.endpoints.items():
            if ep.disconnected and addr not in self._disc_corrected:
                self._disc_corrected.add(addr)
                self._force_disconnect_correction(addr)
        if self._disc_notices:
            now = now_s()
            for h in list(self._disc_notices):
                f, until = self._disc_notices[h]
                if now >= until:
                    del self._disc_notices[h]
                    continue
                for ep in self.endpoints.values():
                    if not ep.disconnected and ep.state == SessionState.RUNNING:
                        ep.send_disc_notice(h, f)
        # retransmit un-acked local inputs + acks
        for ep in self.endpoints.values():
            if ep.state == SessionState.RUNNING and not ep.disconnected:
                ep.send_inputs(self._local_sent)
        for ep in self.spectator_endpoints.values():
            if ep.state == SessionState.RUNNING and not ep.disconnected:
                ep.send_inputs(self._spectator_sent)
        self._drive_desync_detection()

    def _local_advantage(self, ep: PeerEndpoint) -> int:
        if ep.last_received_frame == NULL_FRAME:
            return 0
        adv = self.current_frame - ep.last_received_frame
        ep.time_sync.note_local(self.current_frame, ep.last_received_frame)
        return adv

    def _make_on_input(self, addr):
        def cb(frame: int, raw: bytes) -> None:
            hs = self._handle_of_addr[addr]
            for i, h in enumerate(hs):
                chunk = raw[i * self.input_size:(i + 1) * self.input_size]
                value = np.frombuffer(chunk, self.input_dtype).reshape(
                    self.input_shape
                )
                self.queues[h].add_remote(frame, value)

        return cb

    def _make_on_stream_base(self, addr):
        def cb(base: int) -> None:
            for h in self._handle_of_addr[addr]:
                self.queues[h].set_base(base)

        return cb

    def _make_on_checksum(self, addr):
        def cb(frame: int, checksum: int) -> None:
            self._remote_checksums[(addr, frame)] = checksum

        return cb

    # -- advancing ----------------------------------------------------------

    def add_local_input(self, handle: int, value) -> None:
        """Stage this tick's input for a local handle."""
        if handle not in self.local_handles:
            raise InvalidRequestError(f"handle {handle} is not local")
        if self.current_state() != SessionState.RUNNING:
            raise NotSynchronizedError()
        self._staged[handle] = np.asarray(value, self.input_dtype).reshape(
            self.input_shape
        )

    def advance_frame(self) -> List:
        """Decide save/rollback/advance; returns the request stream."""
        if self.current_state() != SessionState.RUNNING:
            raise NotSynchronizedError()
        missing = set(self.local_handles) - set(self._staged)
        if missing:
            raise InvalidRequestError(f"missing local input for {sorted(missing)}")

        # stall check BEFORE consuming inputs, so the tick can retry.
        # confirmed must NOT advance past a pending mispredicted frame: the
        # rollback target has to stay in the runner's snapshot ring (a late
        # redundant input batch can otherwise leapfrog it)
        new_confirmed = self._compute_confirmed()
        pending_fi = NULL_FRAME
        for q in self.queues.values():
            f = q.first_incorrect
            if f != NULL_FRAME and (
                pending_fi == NULL_FRAME or frame_lt(f, pending_fi)
            ):
                pending_fi = f
        if pending_fi != NULL_FRAME:
            new_confirmed = frame_min(new_confirmed, pending_fi)
        if frame_diff(self.current_frame, new_confirmed) > self._max_prediction:
            self._staged.clear()
            raise PredictionThresholdError()

        # commit local inputs (delay applied by the queue) + broadcast
        eff_frames = {}
        for h in self.local_handles:
            eff_frames[h] = self.queues[h].add_local(
                self.current_frame, self._staged[h]
            )
        self._staged.clear()
        eff = eff_frames[self.local_handles[0]] if self.local_handles else None
        if eff is not None:
            raw = b"".join(
                np.ascontiguousarray(
                    self.queues[h].confirmed_input(eff)
                ).tobytes()
                for h in self.local_handles
            )
            self._local_sent.append((eff, raw))
            if _REG.enabled:
                # flow-correlation anchor: a remote peer's rollback blaming
                # (handle, frame) pairs with this send in the merged Chrome
                # trace (telemetry/trace.py — one arrow from cause to effect)
                _record_event("input_send", frame=eff,
                                 handles=list(self.local_handles), size=len(raw))
            for ep in self.endpoints.values():
                if ep.state == SessionState.RUNNING and not ep.disconnected:
                    ep.send_inputs(self._local_sent)

        requests: List = []

        # rollback on misprediction — tracking WHOSE queue owns the earliest
        # incorrect frame, so the LoadRequest carries the blamed handle
        # (rollback-cause attribution; docs/observability.md "Network & QoS")
        first_incorrect = NULL_FRAME
        blamed_handle = None
        blamed_mismatch = False
        for h, q in self.queues.items():
            f = q.take_first_incorrect()
            if f != NULL_FRAME and (
                first_incorrect == NULL_FRAME or frame_lt(f, first_incorrect)
            ):
                first_incorrect = f
                blamed_handle = h
                blamed_mismatch = q.first_incorrect_mismatch
        rolled_back = False
        if first_incorrect != NULL_FRAME and frame_lt(
            first_incorrect, self.current_frame
        ):
            requests.append(LoadRequest(first_incorrect, cause=RollbackCause(
                handle=blamed_handle,
                frame=first_incorrect,
                lateness=frame_diff(self.current_frame, first_incorrect),
                mismatch=blamed_mismatch,
                kind="misprediction" if blamed_mismatch else "disconnect",
            )))
            i = first_incorrect
            while i != self.current_frame:
                inputs, status = self._inputs_for(i)
                requests.append(AdvanceRequest(inputs, status))
                requests.append(SaveRequest(frame_add(i, 1), SaveCell(self, frame_add(i, 1))))
                i = frame_add(i, 1)
            rolled_back = True

        self._confirmed = new_confirmed
        self._gc()

        if not rolled_back:
            requests.append(
                SaveRequest(self.current_frame, SaveCell(self, self.current_frame))
            )
        inputs, status = self._inputs_for(self.current_frame)
        requests.append(AdvanceRequest(inputs, status))
        self.current_frame = frame_add(self.current_frame, 1)
        self._stream_confirmed_to_spectators()
        return requests

    def _inputs_for(self, frame: int) -> Tuple[np.ndarray, np.ndarray]:
        inputs = np.zeros((self._num_players, *self.input_shape), self.input_dtype)
        status = np.zeros((self._num_players,), np.int8)
        for h in range(self._num_players):
            if (
                h in self.remote_handle_addr
                and self.endpoints[self.remote_handle_addr[h]].disconnected
            ):
                # frames at or before the disconnect-consensus frame keep
                # their REAL confirmed input (a deep rollback spanning
                # pre-disconnect frames must reproduce the original sim —
                # zeroing them would desync the survivor from its own
                # ring); only frames past it bake the disconnect policy
                v = self.queues[h].confirmed_input(frame)
                if v is not None:
                    inputs[h] = v
                    status[h] = InputStatus.CONFIRMED
                else:
                    status[h] = InputStatus.DISCONNECTED
                continue
            value, st = self.queues[h].input_for(frame)
            inputs[h] = value
            status[h] = st
        return inputs, status

    def _force_disconnect_correction(self, addr) -> None:
        """A remote endpoint just hit the disconnect timeout: frames advanced
        with served predictions for its handles will never be corrected by
        the wire (its packets are dropped from here on).  Adopt OUR last
        real frame as the disconnect-consensus frame for each of its
        handles (forcing the rollback that bakes the disconnect policy in
        BEFORE ``_compute_confirmed`` — which skips disconnected remotes —
        can leapfrog the uncorrected predictions), and announce it so every
        survivor converges on the same frame."""
        for h in self._handle_of_addr.get(addr, []):
            self._adopt_disconnect(h, self.queues[h].last_confirmed)

    def _adopt_disconnect(self, handle: int, frame: int) -> None:
        """Adopt a disconnect-consensus frame for ``handle`` (GGPO-style
        min rule): keep real inputs up to ``frame``, resimulate everything
        after it as DISCONNECTED/zero, and rebroadcast the adopted value.

        The adoption is clamped to our confirmed frame: frames at or below
        it may already be pruned from the snapshot ring, so a notice
        reaching further back than that cannot be honored — the residual
        divergence (the announcer never received an input we already
        finalized) is the classic disconnect race; desync detection is the
        backstop, and the min-rule plus prompt notices make it vanishingly
        rare in practice (survivors stall within one prediction window of
        the dead peer's stream, so their knowledge differs by at most the
        frames in flight)."""
        q = self.queues[handle]
        f = frame_min(frame, q.last_confirmed)
        if self._confirmed != NULL_FRAME and frame_lt(f, self._confirmed):
            f = self._confirmed
        cur = self._disc_frame.get(handle)
        if cur is not None and frame_ge(f, cur):
            return  # min rule: only ever adopt downward
        self._disc_frame[handle] = f
        q.truncate_after(f)
        nxt = frame_add(f, 1)
        if frame_lt(nxt, self.current_frame) and (
            q.first_incorrect == NULL_FRAME
            or frame_lt(nxt, q.first_incorrect)
        ):
            # frames after f were advanced on richer inputs (or stale
            # predictions): the standard mismatch-rollback path replays
            # them under the disconnect policy (a structural truncation,
            # not a served-prediction mismatch — attribution reads the flag)
            q.first_incorrect = nxt
            q.first_incorrect_mismatch = False
        self._disc_notices[handle] = (f, now_s() + DISC_NOTICE_REBROADCAST_S)

    def _make_on_disc_notice(self, addr):
        def cb(handle: int, frame: int) -> None:
            dead_addr = self.remote_handle_addr.get(handle)
            if dead_addr is None or dead_addr == addr:
                return  # our own handle, unknown, or a peer announcing itself
            ep = self.endpoints[dead_addr]
            if not ep.disconnected:
                # consistency over liveness (GGPO): a peer the others
                # dropped is dropped here too, immediately — otherwise we
                # would keep confirming inputs the survivors will never see.
                # UNAUTHENTICATED by design: trusted-peer model, see
                # docs/architecture.md "Trust model (networking)"
                ep.disconnected = True
                ep.events.append(Disconnected(dead_addr))
                self._disc_corrected.add(dead_addr)
                # adopt EVERY handle of the dead peer from local knowledge
                # first: the notice names one handle, but a multi-handle
                # peer's other streams need their correction even if the
                # announcer's per-handle notices never arrive
                self._force_disconnect_correction(dead_addr)
            self._adopt_disconnect(handle, frame)

        return cb

    def _compute_confirmed(self) -> int:
        c = self.current_frame
        for h, addr in self.remote_handle_addr.items():
            if self.endpoints[addr].disconnected:
                continue
            c = frame_min(c, self.queues[h].last_confirmed)
        return c

    def _gc(self) -> None:
        horizon = frame_add(self._confirmed, -self._max_prediction - 2)
        for q in self.queues.values():
            q.gc(horizon)
        acked = _min_ack(self.endpoints.values())
        if acked is None:
            self._local_sent = []  # no connected remotes: nothing to deliver
        elif acked != NULL_FRAME:
            self._local_sent = [
                p for p in self._local_sent if frame_gt(p[0], acked)
            ]
        if len(self._local_sent) > MAX_UNACKED_FRAMES:
            self._local_sent = self._local_sent[-MAX_UNACKED_FRAMES:]
        for fr in [f for f in self._local_checksums if frame_lt(f, horizon)]:
            entry = self._local_checksums.pop(fr)
            if (
                callable(entry)
                and self.desync_detection.enabled
                and fr % self.desync_detection.interval == 0
                and frame_le(fr, self._confirmed)
            ):
                # backstop: an interval frame leaving the window whose async
                # copy never landed — force it now (ONE blocking readback,
                # counted as forced) rather than silently dropping the
                # comparison.  Steady state never reaches this: harvest()
                # lands copies within a tick or two while the horizon trails
                # confirmed by max_prediction + 2 frames.
                v = self._resolve_checksum(entry, True)
                if v is not None:
                    self._publish_checksum(fr, v)
                    self._compare_checksum(fr, v)
        for key in [k for k in self._remote_checksums if frame_lt(k[1], horizon)]:
            del self._remote_checksums[key]

    # -- spectator streaming -------------------------------------------------

    def _stream_confirmed_to_spectators(self) -> None:
        if not self.spectator_endpoints:
            return
        while frame_le(self._next_spectator_frame, self._confirmed):
            f = self._next_spectator_frame
            rows = []
            stats = bytearray()
            for h in range(self._num_players):
                v = self.queues[h].confirmed_input(f)
                if v is None:
                    # stream the status the HOST's sim actually used, so a
                    # status-sensitive spectator replays bit-identically:
                    # a dead player's post-consensus frames are
                    # DISCONNECTED; pre-stream-base frames were advanced
                    # on the PREDICTED default
                    disc = (
                        h in self.remote_handle_addr
                        and self.endpoints[
                            self.remote_handle_addr[h]
                        ].disconnected
                    )
                    stats.append(
                        int(InputStatus.DISCONNECTED)
                        if disc
                        else int(InputStatus.PREDICTED)
                    )
                    v = self.queues[h].default_input()
                else:
                    stats.append(int(InputStatus.CONFIRMED))
                rows.append(np.ascontiguousarray(v).tobytes())
            self._spectator_sent.append((f, b"".join(rows) + bytes(stats)))
            self._next_spectator_frame = frame_add(self._next_spectator_frame, 1)
        acked = _min_ack(self.spectator_endpoints.values())
        if acked is None:
            self._spectator_sent = []  # every spectator disconnected
        elif acked != NULL_FRAME:
            self._spectator_sent = [
                p for p in self._spectator_sent if frame_gt(p[0], acked)
            ]
        if len(self._spectator_sent) > MAX_UNACKED_FRAMES:
            self._spectator_sent = self._spectator_sent[-MAX_UNACKED_FRAMES:]

    # -- desync detection ----------------------------------------------------

    def _on_cell_saved(self, frame: int, provider) -> None:
        if self.desync_detection.enabled:
            self._local_checksums[frame] = provider

    def check_now(self) -> None:
        """Flush point: force every deferred local checksum provider and
        publish/compare immediately (``Runner.finish()`` / ``set_session``
        reach this through the same ``check_now`` hook SyncTest uses).  The
        steady-state path never forces — see :meth:`_drive_desync_detection`."""
        self._drive_desync_detection(force=True)

    @staticmethod
    def _resolve_checksum(provider, force: bool):
        """Provider -> masked 64-bit value, or None when not yet available.

        The non-forcing path uses the provider's ``peek()`` (non-blocking;
        starts the device->host copy and returns None until it lands — the
        runner simply retries next poll, riding the protocol's existing
        tolerance for late checksums).  Forcing blocks on the device and is
        reserved for flush points, the GC backstop, and eager/sync mode."""
        if not force:
            peek = getattr(provider, "peek", None)
            if peek is not None:
                v = peek()
            else:
                v = provider()  # host-side provider: no device to wait on
        else:
            v = provider()
        return None if v is None else v & (2**64 - 1)

    def _publish_checksum(self, frame: int, value: int) -> None:
        for ep in self.endpoints.values():
            if not ep.disconnected and ep.state == SessionState.RUNNING:
                ep.send_checksum(frame, value)

    def _compare_checksum(self, frame: int, local: int) -> None:
        """Compare a resolved local checksum against any received reports."""
        for (addr, f), remote in list(self._remote_checksums.items()):
            if f == frame:
                if remote != local:
                    if _REG.enabled:
                        _REG.counter("checksum_mismatch_total",
                                     "frames whose checksums disagreed").inc(kind="p2p")
                    self.events_buf.append(
                        DesyncDetected(
                            frame=f,
                            local_checksum=local,
                            remote_checksum=remote,
                            addr=addr,
                        )
                    )
                del self._remote_checksums[(addr, f)]

    def _drive_desync_detection(self, force: bool = False) -> None:
        if not self.desync_detection.enabled:
            return
        interval = self.desync_detection.interval
        remote_frames = {f for (_, f) in self._remote_checksums}
        for frame in sorted(self._local_checksums):
            if frame % interval != 0 or not frame_le(frame, self._confirmed):
                continue
            entry = self._local_checksums[frame]
            if callable(entry):
                entry = self._resolve_checksum(
                    entry, force or self.eager_checksums
                )
                if entry is None:
                    continue  # copy in flight — retry next poll
                self._local_checksums[frame] = entry
                self._publish_checksum(frame, entry)
            # a resolved local sticks around until the remote report shows
            # up (or GC) — only walk the comparison dict when it has a
            # matching frame, not on every poll
            if frame in remote_frames:
                self._compare_checksum(frame, entry)
