"""Sessions: SyncTest, P2P (Python and native core), spectator, their
builder, the wire protocol and transports, the room server and input
replay (port of ``bevy_ggrs_tpu/session``)."""

from .events import (
    InputStatus,
    SessionState,
    PlayerType,
    Player,
    DesyncDetection,
    Synchronizing,
    Synchronized,
    Disconnected,
    NetworkInterrupted,
    NetworkResumed,
    DesyncDetected,
    GgrsError,
    PredictionThresholdError,
    MismatchedChecksumError,
    NotSynchronizedError,
    InvalidRequestError,
    NetworkStats,
)
from .requests import SaveRequest, LoadRequest, AdvanceRequest, SaveCell, GgrsRequest
from .synctest import SyncTestSession
from .input_queue import InputQueue
from .time_sync import TimeSync
from .transport import TcpNonBlockingSocket, UdpNonBlockingSocket, NonBlockingSocket
from .p2p import P2PSession
from .spectator import SpectatorSession
from .builder import SessionBuilder
from .native import NativeP2PSession, NativeSpectatorSession, native_available
from .room import RoomServer, RoomSocket, assign_handles, wait_for_players
from .replay import InputRecorder, ReplaySession

__all__ = [
    "InputStatus",
    "SessionState",
    "PlayerType",
    "Player",
    "DesyncDetection",
    "Synchronizing",
    "Synchronized",
    "Disconnected",
    "NetworkInterrupted",
    "NetworkResumed",
    "DesyncDetected",
    "GgrsError",
    "PredictionThresholdError",
    "MismatchedChecksumError",
    "NotSynchronizedError",
    "InvalidRequestError",
    "NetworkStats",
    "SaveRequest",
    "LoadRequest",
    "AdvanceRequest",
    "SaveCell",
    "GgrsRequest",
    "SyncTestSession",
    "InputQueue",
    "TimeSync",
    "UdpNonBlockingSocket",
    "TcpNonBlockingSocket",
    "NonBlockingSocket",
    "P2PSession",
    "SpectatorSession",
    "SessionBuilder",
    "NativeP2PSession",
    "NativeSpectatorSession",
    "native_available",
    "RoomServer",
    "RoomSocket",
    "assign_handles",
    "wait_for_players",
    "InputRecorder",
    "ReplaySession",
]
