"""Session-facing enums and errors used by SyncTest and the runner.

A copy of the parts of ``bevy_ggrs_tpu/session/events.py`` that this slice
needs (the port imports nothing of the JAX package)."""

from __future__ import annotations

import enum
from typing import List


class InputStatus(enum.IntEnum):
    """Per-player input status delivered with PlayerInputs."""

    CONFIRMED = 0
    PREDICTED = 1
    DISCONNECTED = 2


class GgrsError(Exception):
    """Base class of session errors (GgrsError analog)."""


class MismatchedChecksumError(GgrsError):
    """SyncTest resimulation produced a different checksum."""

    def __init__(self, current_frame: int, mismatched_frames: List[int]):
        self.current_frame = current_frame
        self.mismatched_frames = mismatched_frames
        super().__init__(
            f"checksum mismatch at frames {mismatched_frames} "
            f"(current frame {current_frame})"
        )


class InvalidRequestError(GgrsError):
    """Misuse of the session API (bad handle, missing input, ...)."""
