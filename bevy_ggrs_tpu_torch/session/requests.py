"""GgrsRequest stream — the contract between sessions and the runner.

A copy of ``bevy_ggrs_tpu/session/requests.py``.  Like the reference, the
save cell carries only the checksum — state lives in the runner's snapshot
ring.  The checksum is passed as a provider (a callable returning the
64-bit value), so a device->host copy happens only when the session needs
the value."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Union

import numpy as np


class SaveCell:
    """Session-owned storage for one saved frame's checksum."""

    def __init__(self, session, frame: int):
        self._session = session
        self.frame = frame

    def save(self, frame: int, checksum_provider: Optional[Callable[[], int]]):
        """Record the checksum provider for this frame (state stays
        runner-side)."""
        self._session._on_cell_saved(frame, checksum_provider)


@dataclass
class SaveRequest:
    """SaveGameState: snapshot the current frame (cell takes the checksum)."""
    frame: int
    cell: SaveCell


@dataclass
class RollbackCause:
    """Why a LoadRequest happened — the rollback-cause attribution payload
    (``handle`` is the blamed player, or a tag such as ``"resim"`` for
    SyncTest's structural re-simulation)."""

    handle: object = "unknown"
    frame: int = 0
    lateness: int = 0
    mismatch: bool = False
    kind: str = "misprediction"  # | "disconnect" | "resim" | "unknown"


@dataclass
class LoadRequest:
    """LoadGameState: restore the ring snapshot for ``frame``."""
    frame: int
    cause: Optional[RollbackCause] = None


@dataclass
class AdvanceRequest:
    """Inputs for one frame: [num_players, ...] array + per-player status."""

    inputs: np.ndarray
    status: np.ndarray  # int8[num_players] of InputStatus values


GgrsRequest = Union[SaveRequest, LoadRequest, AdvanceRequest]
