"""Session-facing enums, events, and errors — the GGRS surface the runner and
user code consume (reconstructed API per SURVEY.md §2.3; citations inline).

A copy of ``bevy_ggrs_tpu/session/events.py`` (the port imports nothing of
the JAX package)."""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Any, List, Optional


class InputStatus(enum.IntEnum):
    """Per-player input status delivered with PlayerInputs
    (bevy_ggrs src/lib.rs:92-94)."""

    CONFIRMED = 0
    PREDICTED = 1
    DISCONNECTED = 2


class SessionState(enum.Enum):
    """P2P/Spectator lifecycle (`current_state()`,
    bevy_ggrs src/schedule_systems.rs:140)."""

    SYNCHRONIZING = "synchronizing"
    RUNNING = "running"


class PlayerType(enum.Enum):
    """LOCAL / REMOTE / SPECTATOR (PlayerType analog)."""
    LOCAL = "local"
    REMOTE = "remote"
    SPECTATOR = "spectator"


@dataclass(frozen=True)
class Player:
    """One player slot: kind + handle (+ peer address for remote/spectator)."""
    kind: PlayerType
    handle: int
    address: Optional[Any] = None  # remote/spectator peer address


class DesyncDetection:
    """Desync-detection mode (`with_desync_detection_mode`, SURVEY §2.3)."""

    def __init__(self, interval: Optional[int] = None):
        self.interval = interval  # None = Off; n = compare every n frames

    OFF: "DesyncDetection"

    @staticmethod
    def on(interval: int) -> "DesyncDetection":
        return DesyncDetection(interval)

    @property
    def enabled(self) -> bool:
        return self.interval is not None


DesyncDetection.OFF = DesyncDetection(None)


# -- events (GgrsEvent<T>, consumed via session.events();
#    bevy_ggrs examples/box_game/box_game_p2p.rs:104-119) --------------


@dataclass(frozen=True)
class Synchronizing:
    """Sync handshake progress with a peer (count/total roundtrips)."""
    addr: Any
    total: int
    count: int


@dataclass(frozen=True)
class Synchronized:
    """Peer completed the sync handshake."""
    addr: Any


@dataclass(frozen=True)
class Disconnected:
    """Peer exceeded the disconnect timeout."""
    addr: Any


@dataclass(frozen=True)
class NetworkInterrupted:
    """Peer quiet past the notify threshold (may still resume)."""
    addr: Any
    disconnect_timeout_ms: int


@dataclass(frozen=True)
class NetworkResumed:
    """Interrupted peer spoke again."""
    addr: Any


@dataclass(frozen=True)
class DesyncDetected:
    """A confirmed frame's checksum differs from a peer's."""
    frame: int
    local_checksum: int
    remote_checksum: int
    addr: Any


# -- errors (GgrsError) ------------------------------------------------------


class GgrsError(Exception):
    """Base class of session errors (GgrsError analog)."""
    pass


class PredictionThresholdError(GgrsError):
    """Too far ahead of remote inputs — the runner counts a stall and skips
    the frame (bevy_ggrs src/schedule_systems.rs:162-164)."""


class MismatchedChecksumError(GgrsError):
    """SyncTest resimulation produced a different checksum
    (bevy_ggrs src/schedule_systems.rs:106-115)."""

    def __init__(self, current_frame: int, mismatched_frames: List[int]):
        self.current_frame = current_frame
        self.mismatched_frames = mismatched_frames
        super().__init__(
            f"checksum mismatch at frames {mismatched_frames} "
            f"(current frame {current_frame})"
        )


class NotSynchronizedError(GgrsError):
    """Session is still synchronizing with remotes."""


class InvalidRequestError(GgrsError):
    """Misuse of the session API (bad handle, missing input, ...)."""


@dataclass
class NetworkStats:
    """`network_stats(handle)` surface
    (bevy_ggrs examples/box_game/box_game_p2p.rs:121-142).

    ``is_live`` is False for handles with no live endpoint behind them —
    local handles, disconnected peers, spectators.  Those return a zeroed
    snapshot instead of raising, so samplers can walk every handle without
    try/except churn."""

    ping_ms: float = 0.0
    send_queue_len: int = 0
    kbps_sent: float = 0.0
    local_frames_behind: int = 0
    remote_frames_behind: int = 0
    is_live: bool = True
