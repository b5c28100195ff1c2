"""SessionBuilder — the fluent session construction surface (SURVEY §2.3:
``with_num_players``, ``with_max_prediction_window``, ``with_input_delay``,
``with_check_distance``, ``with_desync_detection_mode``, ``add_player``,
``start_{p2p,synctest,spectator}_session`` and the native starters).

A copy of ``bevy_ggrs_tpu/session/builder.py``."""

from __future__ import annotations

from typing import Any, List, Tuple

import numpy as np

from .events import DesyncDetection, InvalidRequestError, Player, PlayerType
from .p2p import P2PSession
from .spectator import SpectatorSession
from .synctest import SyncTestSession


class SessionBuilder:
    """Fluent session construction (see module docstring for the surface)."""
    def __init__(self, input_shape: Tuple[int, ...] = (), input_dtype=np.uint8):
        self.input_shape = tuple(input_shape)
        self.input_dtype = np.dtype(input_dtype)
        self._num_players = 2
        self._max_prediction = 8
        self._input_delay = 0
        self._check_distance = 2
        self._desync = DesyncDetection.OFF
        self._players: List[Player] = []
        self._disconnect_timeout_s = 2.0
        self._disconnect_notify_start_s = 0.5
        self._catchup_speed = 1
        self._input_predictor = None
        self._eager_checksums = False

    @classmethod
    def for_app(cls, app) -> "SessionBuilder":
        """Builder pre-filled with the app's input spec and player count."""
        b = cls(app.input_shape, app.input_dtype)
        b._num_players = app.num_players
        return b

    def with_num_players(self, n: int) -> "SessionBuilder":
        """Set the total player count (handles 0..n-1)."""
        if n < 1:
            raise InvalidRequestError("num_players must be >= 1")
        self._num_players = n
        return self

    def with_max_prediction_window(self, n: int) -> "SessionBuilder":
        """Frames the session may run ahead of confirmed inputs before stalling."""
        self._max_prediction = n
        return self

    def with_input_delay(self, n: int) -> "SessionBuilder":
        """Frames of local input delay (trades latency for fewer rollbacks)."""
        self._input_delay = n
        return self

    def with_check_distance(self, n: int) -> "SessionBuilder":
        """SyncTest resimulation depth per tick."""
        self._check_distance = n
        return self

    def with_desync_detection_mode(self, mode: DesyncDetection) -> "SessionBuilder":
        """Enable periodic cross-peer checksum comparison (DesyncDetection.on(n))."""
        self._desync = mode
        return self

    def with_input_predictor(self, predictor) -> "SessionBuilder":
        """Override remote-input prediction (the Config::InputPredictor slot,
        SURVEY §2.3); default PredictRepeatLast.  ``predictor(queue, frame)``
        returns the guessed input value."""
        self._input_predictor = predictor
        return self

    def with_eager_checksums(self, eager: bool = True) -> "SessionBuilder":
        """Force desync-detection checksum providers at the tick their frame
        confirms (the pre-pipeline synchronous behavior — the bench's sync
        baseline).  Default off: providers are peeked non-blocking and
        published when the async device->host copy lands."""
        self._eager_checksums = eager
        return self

    def with_disconnect_timeout(self, seconds: float) -> "SessionBuilder":
        """Seconds of peer silence before Disconnected."""
        self._disconnect_timeout_s = seconds
        return self

    def with_disconnect_notify_delay(self, seconds: float) -> "SessionBuilder":
        """Seconds of peer silence before NetworkInterrupted."""
        self._disconnect_notify_start_s = seconds
        return self

    def with_catchup_speed(self, frames_per_tick: int) -> "SessionBuilder":
        """Extra confirmed frames a lagging spectator replays per tick
        (the reference's SessionBuilder::with_catchup_speed; spectator
        sessions only)."""
        if frames_per_tick < 1:
            raise ValueError("catchup_speed must be >= 1")
        self._catchup_speed = frames_per_tick
        return self

    def add_player(self, kind: PlayerType, handle: int, address: Any = None) -> "SessionBuilder":
        """Add a LOCAL/REMOTE player (by handle) or a SPECTATOR (by address)."""
        if kind != PlayerType.SPECTATOR and not (0 <= handle < self._num_players):
            raise InvalidRequestError(
                f"player handle {handle} out of range 0..{self._num_players}"
            )
        if kind in (PlayerType.REMOTE, PlayerType.SPECTATOR) and address is None:
            raise InvalidRequestError(f"{kind} player needs an address")
        self._players.append(Player(kind, handle, address))
        return self

    def start_p2p_session(self, socket) -> P2PSession:
        """Build a python-core P2P session over the given socket."""
        handles = {p.handle for p in self._players if p.kind != PlayerType.SPECTATOR}
        if handles != set(range(self._num_players)):
            raise InvalidRequestError(
                f"players incomplete: have handles {sorted(handles)}"
            )
        return P2PSession(
            num_players=self._num_players,
            players=self._players,
            socket=socket,
            input_shape=self.input_shape,
            input_dtype=self.input_dtype,
            max_prediction=self._max_prediction,
            input_delay=self._input_delay,
            desync_detection=self._desync,
            disconnect_timeout_s=self._disconnect_timeout_s,
            disconnect_notify_start_s=self._disconnect_notify_start_s,
            input_predictor=self._input_predictor,
            eager_checksums=self._eager_checksums,
        )

    def start_p2p_session_native(self, local_port: int = 0):
        """P2P session backed by the native C++ host runtime
        (native/ggrs_core) — same wire protocol, same request stream."""
        from .native import NativeP2PSession

        handles = {p.handle for p in self._players if p.kind != PlayerType.SPECTATOR}
        if handles != set(range(self._num_players)):
            raise InvalidRequestError(
                f"players incomplete: have handles {sorted(handles)}"
            )
        return NativeP2PSession(
            num_players=self._num_players,
            players=self._players,
            local_port=local_port,
            input_shape=self.input_shape,
            input_dtype=self.input_dtype,
            max_prediction=self._max_prediction,
            input_delay=self._input_delay,
            desync_detection=self._desync,
            disconnect_timeout_s=self._disconnect_timeout_s,
            disconnect_notify_start_s=self._disconnect_notify_start_s,
        )

    def start_synctest_session(self) -> SyncTestSession:
        return SyncTestSession(
            num_players=self._num_players,
            input_shape=self.input_shape,
            input_dtype=self.input_dtype,
            check_distance=self._check_distance,
            input_delay=self._input_delay,
            max_prediction=self._max_prediction,
        )

    def start_spectator_session_native(self, host_addr: Any, local_port: int = 0):
        """Spectator session backed by the native C++ core."""
        from .native import NativeSpectatorSession

        return NativeSpectatorSession(
            num_players=self._num_players,
            host_addr=host_addr,
            local_port=local_port,
            input_shape=self.input_shape,
            input_dtype=self.input_dtype,
            disconnect_timeout_s=self._disconnect_timeout_s,
            disconnect_notify_start_s=self._disconnect_notify_start_s,
            catchup_speed=self._catchup_speed,
        )

    def start_spectator_session(self, host_addr: Any, socket) -> SpectatorSession:
        return SpectatorSession(
            num_players=self._num_players,
            host_addr=host_addr,
            socket=socket,
            input_shape=self.input_shape,
            input_dtype=self.input_dtype,
            disconnect_timeout_s=self._disconnect_timeout_s,
            disconnect_notify_start_s=self._disconnect_notify_start_s,
            catchup_speed=self._catchup_speed,
        )
