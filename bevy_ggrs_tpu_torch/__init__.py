"""bevy_ggrs_tpu_torch — the PyTorch / CUDA port of ``bevy_ggrs_tpu``.

GGPO-style rollback netcode for deterministic simulations whose state is
columnar SoA tensors on an NVIDIA GPU.  A rollback of N frames is one
resim call returning every intermediate state and checksum; the checksum
fold is a CUDA kernel written for Hopper (``csrc/checksum_fold.cu``).
Speculation fans M predicted remote-input branches out along a
``torch.func.vmap`` branch axis and serves a rollback whose corrected
inputs were hedged from that cache (``ops/speculation.py``).  A game
server runs M lobbies over one resident ``[M, ...]`` world with
:class:`BatchedRunner`, one call per wave (``ops/batch.py``).  The
session/network layer (input queues, prediction, sync/quality/desync
protocol, UDP transport) runs on the host, in Python or in the native C++
core.

The module layout and names mirror the JAX package, which stays the
reference.  This package imports torch, never JAX, and nothing of
``bevy_ggrs_tpu``.  Entry points run on CUDA unless given
``device="cpu"``.  The top-level names, and those of ``ops`` and
``utils``, are the JAX package's, so a user's imports switch packages by
name alone.
"""

from .app import DEFAULT_FPS, App
from .batch_runner import BatchedRunner
from .ops.batch import BucketedWaveExecutor, stack_worlds, unstack_world
from .ops.resim import StepCtx, select_branch, slice_frame
from .ops.speculation import SpeculationCache, SpeculationConfig, pad_candidates
from .ops.variant_probe import VariantProbeReport, probe_program_variants
from .runner import GgrsRunner
from .session import (
    DesyncDetection,
    GgrsError,
    InputStatus,
    InputRecorder,
    InvalidRequestError,
    MismatchedChecksumError,
    NativeP2PSession,
    NativeSpectatorSession,
    NetworkStats,
    NotSynchronizedError,
    P2PSession,
    Player,
    PlayerType,
    PredictionThresholdError,
    ReplaySession,
    RoomServer,
    RoomSocket,
    SessionBuilder,
    SessionState,
    SpectatorSession,
    SyncTestSession,
    TcpNonBlockingSocket,
    UdpNonBlockingSocket,
    assign_handles,
    wait_for_players,
)
from .snapshot import (
    CloneStrategy,
    CopyStrategy,
    MissingSnapshotError,
    QuantizeStrategy,
    ReflectStrategy,
    Registry,
    SnapshotRing,
    Strategy,
    WorldState,
    active_count,
    active_mask,
    checksum_to_int,
    despawn,
    despawn_recursive,
    despawn_where,
    insert_component,
    insert_resource,
    remove_component,
    remove_resource,
    spawn,
    spawn_many,
    world_checksum,
)
from .snapshot.persist import Checkpoint, load_checkpoint, load_world, save_world
from .utils.frames import NULL_FRAME

__version__ = "0.1.0"  # the JAX package's

__all__ = [
    "App", "GgrsRunner", "SessionBuilder", "SyncTestSession", "P2PSession",
    "SpectatorSession", "NativeP2PSession", "NativeSpectatorSession",
    "UdpNonBlockingSocket", "TcpNonBlockingSocket",
    "InputStatus", "SessionState", "PlayerType", "Player", "DesyncDetection",
    "GgrsError", "PredictionThresholdError", "MismatchedChecksumError",
    "NotSynchronizedError", "InvalidRequestError", "NetworkStats", "NULL_FRAME",
    "StepCtx", "select_branch", "slice_frame",
    "SpeculationConfig", "SpeculationCache", "pad_candidates",
    "BatchedRunner", "BucketedWaveExecutor", "stack_worlds", "unstack_world",
    "probe_program_variants", "VariantProbeReport",
    "Strategy", "CopyStrategy", "CloneStrategy", "ReflectStrategy", "QuantizeStrategy",
    "RoomServer", "RoomSocket", "assign_handles", "wait_for_players",
    "InputRecorder", "ReplaySession",
    "save_world", "load_world", "load_checkpoint", "Checkpoint",
    "DEFAULT_FPS", "Registry", "WorldState", "SnapshotRing", "MissingSnapshotError",
    "active_mask", "active_count", "spawn", "spawn_many", "despawn", "despawn_where",
    "despawn_recursive", "insert_component", "remove_component", "insert_resource",
    "remove_resource", "world_checksum", "checksum_to_int",
]
