"""SpectatorSession — follow a host's session without playing.

Receives confirmed all-player inputs streamed by the host's P2PSession and
replays them; never predicts (the runner forces MaxPredictionWindow(0),
bevy_ggrs src/schedule_systems.rs:200).  ``advance_frame`` raises
PredictionThreshold while the next confirmed input has not arrived
(the runner counts a stall and skips, :129-135).

A copy of ``bevy_ggrs_tpu/session/spectator.py``, its catch-up telemetry
(``spectator_catchup_ticks_total`` and the ``spectator_catchup`` timeline
event) included."""

from __future__ import annotations

import random
from typing import Any, Dict, List

import numpy as np

from ..telemetry.timeline import record as _record_event
from ..telemetry.metrics import registry
from ..utils.frames import NULL_FRAME, frame_add, frame_diff
from .events import (
    NetworkStats,
    NotSynchronizedError,
    PredictionThresholdError,
    SessionState,
)
from .protocol import PeerEndpoint
from .requests import AdvanceRequest


class SpectatorSession:
    """Replays host-confirmed inputs; never predicts (see module docstring)."""
    is_spectator = True

    def __init__(
        self,
        num_players: int,
        host_addr: Any,
        socket,
        input_shape=(),
        input_dtype=np.uint8,
        disconnect_timeout_s: float = 2.0,
        disconnect_notify_start_s: float = 0.5,
        catchup_speed: int = 1,
    ):
        self._num_players = num_players
        self.host_addr = host_addr
        self.socket = socket
        self.input_shape = tuple(input_shape)
        self.input_dtype = np.dtype(input_dtype)
        self.input_size = int(np.prod(self.input_shape, dtype=int) or 1) * self.input_dtype.itemsize
        self.current_frame = 0
        self.catchup_speed = catchup_speed
        self.events_buf: List = []
        # frame -> (inputs [P, *shape], statuses int8[P])
        self._inputs: Dict[int, tuple] = {}
        self.endpoint = PeerEndpoint(
            send=lambda data: self.socket.send_to(data, host_addr),
            # full row: all-player inputs + one status byte per player (the
            # host streams the statuses its own sim used, so
            # status-sensitive models replay bit-identically — e.g.
            # DISCONNECTED for a dead player's post-consensus frames)
            input_size=self.input_size * num_players + num_players,
            # handshake nonce — intentionally unique per process
            # (stale-session detection); never enters the simulation
            rng_nonce=random.getrandbits(32),
            disconnect_timeout_s=disconnect_timeout_s,
            disconnect_notify_start_s=disconnect_notify_start_s,
            addr=host_addr,
        )
        self.endpoint.on_input = self._on_input

    def _on_input(self, frame: int, raw: bytes) -> None:
        n = self.input_size * self._num_players
        inputs = np.frombuffer(raw[:n], self.input_dtype).reshape(
            (self._num_players, *self.input_shape)
        )
        status = np.frombuffer(
            raw[n:n + self._num_players], np.int8
        ).copy()
        self._inputs[frame] = (inputs, status)

    # -- GGRS session surface ----------------------------------------------

    def num_players(self) -> int:
        return self._num_players

    def max_prediction(self) -> int:
        return 0  # spectators never predict (schedule_systems.rs:200)

    def confirmed_frame(self) -> int:
        return frame_add(self.current_frame, -1)

    def current_state(self) -> SessionState:
        return (
            SessionState.RUNNING
            if self.endpoint.state == SessionState.RUNNING
            else SessionState.SYNCHRONIZING
        )

    def frames_behind_host(self) -> int:
        """How far the host's confirmed stream is ahead of us."""
        last = self.endpoint.last_received_frame
        if last == NULL_FRAME:
            return 0
        return max(0, frame_diff(last, self.current_frame))

    def events(self):
        """Drain pending session events."""
        out = list(self.endpoint.events)
        self.endpoint.events.clear()
        out += self.events_buf
        self.events_buf = []
        return out

    def network_stats(self, handle: int = 0) -> NetworkStats:
        return self.endpoint.stats()

    def poll_remote_clients(self) -> None:
        """Drain the socket, drive the host endpoint, ack received inputs."""
        for addr, data in self.socket.receive_all():
            if addr == self.host_addr:
                self.endpoint.handle(data)
        self.endpoint.poll()
        if self.endpoint.state == SessionState.RUNNING:
            self.endpoint.send_input_ack()

    def advance_frame(self) -> List:
        """Replay the next confirmed frame(s); raises PredictionThreshold while waiting."""
        if self.current_state() != SessionState.RUNNING:
            raise NotSynchronizedError()
        if self.current_frame not in self._inputs:
            raise PredictionThresholdError()  # waiting for host input
        # catch-up: when lagging the host, replay extra confirmed frames this
        # tick (the reference spectator's catchup behavior)
        n = 1
        if self.frames_behind_host() > 2:
            n += max(self.catchup_speed, 0)
            reg = registry()
            if reg.enabled:
                reg.counter("spectator_catchup_ticks_total",
                            "spectator ticks that replayed extra frames to "
                            "catch up").inc()
                _record_event("spectator_catchup", frame=self.current_frame,
                                 behind=self.frames_behind_host(), replaying=n)
        requests: List = []
        for _ in range(n):
            if self.current_frame not in self._inputs:
                break
            inputs, status = self._inputs.pop(self.current_frame)
            self.current_frame = frame_add(self.current_frame, 1)
            requests.append(AdvanceRequest(np.asarray(inputs), status))
        return requests
