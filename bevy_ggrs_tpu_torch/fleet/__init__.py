"""Fleet layer: multi-host matchmaking, placement, migration, failover.

Port of ``bevy_ggrs_tpu/fleet`` with the same names.  The wire, the
checkpoints and the metric families are the JAX package's, so port and JAX
workers and schedulers interoperate and a lobby's state crosses between the
packages as checkpoint bytes.  Workers host their lobbies on CUDA unless
given ``device="cpu"``.

The packages below promote the single-process room server
(session/room.py) into a fleet control plane:

- :mod:`.protocol` — the wire messages (riding the room framing) between
  scheduler, workers, and clients, plus chunked checkpoint transfer.
- :mod:`.lobby` — the unit of work: a deterministic, checkpointable
  :class:`~.lobby.LobbySim` built from canonical-depth apps so migration
  cannot change bits.
- :mod:`.worker` — one host process: registers, heartbeats, runs placed
  lobbies, drains/ships/restores checkpoints.
- :mod:`.scheduler` — the matchmaker: QoS/bytes-aware greedy placement,
  wire-visible admission control, drain-at-barrier live migration, and
  heartbeat-timeout failover from last-confirmed checkpoints.
- :mod:`.observe` — scheduler-side federation: heartbeat-derived metric
  time-series, SLO burn-rate alerting, and the fleet HTTP surface
  (``/fleet``, ``/qos``, federated ``/metrics``).

See docs/architecture.md "Fleet scheduling & migration" for the lifecycle
diagrams and docs/observability.md for the ``fleet_*`` metric families."""

from .lobby import (
    APP_CATALOG,
    LOBBY_CHUNK,
    LobbySim,
    LobbySpec,
    checksum_hex,
    spec_est_bytes,
    synthetic_inputs,
)
from .observe import (
    AlertEvent,
    FleetObserver,
    SLO,
    SeriesRing,
    default_slos,
    fleet_routes,
    start_fleet_exporter,
)
from .protocol import ChunkAssembler, Msg, chunk_checkpoint, decode
from .scheduler import FleetClient, FleetScheduler, LobbyRecord, WorkerInfo
from .worker import FleetWorker

__all__ = [
    "AlertEvent",
    "FleetObserver",
    "SLO",
    "SeriesRing",
    "default_slos",
    "fleet_routes",
    "start_fleet_exporter",
    "APP_CATALOG",
    "LOBBY_CHUNK",
    "LobbySim",
    "LobbySpec",
    "checksum_hex",
    "spec_est_bytes",
    "synthetic_inputs",
    "ChunkAssembler",
    "Msg",
    "chunk_checkpoint",
    "decode",
    "FleetClient",
    "FleetScheduler",
    "LobbyRecord",
    "WorkerInfo",
    "FleetWorker",
]
