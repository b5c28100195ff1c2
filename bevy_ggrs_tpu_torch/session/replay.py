"""Input-stream recording and deterministic replay.

Port of ``bevy_ggrs_tpu/session/replay.py`` (host only, no device work):
the same recorder, the same ``.npz`` recording format, so a recording made
with either package replays in the other.

A rollback-netcode session is fully determined by its confirmed input
stream, so recording (frame -> all-player inputs) gives free match replays
and a desync post-mortem tool: re-run the recording against any build and
compare checksums frame by frame.  (The reference has no replay facility;
this is a natural extension of its determinism model.)

``InputRecorder`` plugs into the port's :class:`~..runner.GgrsRunner` via
the ``on_advance`` + ``on_confirmed`` hooks.  Every advance is recorded and
a rollback's corrective re-advance overwrites the mispredicted one; a frame
becomes *final* once the session's confirmed frame passes it (a correctly-
predicted frame is never re-advanced, so waiting for an all-confirmed
advance would leave permanent gaps in P2P recordings) or when its advance
already carried all-CONFIRMED inputs.  ``ReplaySession`` feeds the final
frames back through the normal driver as an advance-only session."""

from __future__ import annotations

from typing import Dict, List, Optional, Set

import numpy as np

from ..utils.frames import NULL_FRAME, frame_add, frame_le
from .events import InputStatus, PredictionThresholdError
from .requests import AdvanceRequest


class InputRecorder:
    """Captures the confirmed input stream via the runner's on_advance/on_confirmed hooks."""
    def __init__(self, num_players: int, input_shape=(), input_dtype=np.uint8,
                 canonical_depth=None, canonical_branches=None):
        self.num_players = num_players
        self.input_shape = tuple(input_shape)
        self.input_dtype = np.dtype(input_dtype)
        # program config: replays of variant-unstable float sims are only
        # bit-faithful under the same canonical program (docs/determinism.md)
        self.canonical_depth = canonical_depth
        self.canonical_branches = canonical_branches
        self.frames: Dict[int, np.ndarray] = {}
        # per-frame statuses the sim ACTUALLY used (a dead player's
        # post-consensus frames are DISCONNECTED; replays of
        # status-sensitive models must reproduce that, not all-CONFIRMED)
        self.statuses: Dict[int, np.ndarray] = {}
        self._all_confirmed: Set[int] = set()
        self._watermark: int = NULL_FRAME  # session confirmed frame

    @classmethod
    def for_app(cls, app) -> "InputRecorder":
        """Recorder matching the app's input spec and canonical config."""
        return cls(app.num_players, app.input_shape, app.input_dtype,
                   app.canonical_depth, app.canonical_branches)

    def on_advance(self, frame: int, inputs: np.ndarray, status: np.ndarray) -> None:
        """Runner hook: called for every executed AdvanceFrame request.

        Records unconditionally — a later corrective re-advance (rollback)
        overwrites, so by the time a frame is final the stored value is the
        confirmed truth."""
        self.frames[frame] = np.array(inputs, self.input_dtype)
        self.statuses[frame] = np.array(status, np.int8)
        if np.all(status == InputStatus.CONFIRMED):
            self._all_confirmed.add(frame)

    def on_confirmed(self, frame: int) -> None:
        """Runner hook: the session's confirmed frame advanced to ``frame``."""
        if self._watermark == NULL_FRAME or frame_le(self._watermark, frame):
            self._watermark = frame

    def _is_final(self, frame: int) -> bool:
        # recorded key = post-advance frame; its transition consumed the
        # inputs AT key-1, which are final once confirmed >= key-1, i.e.
        # key <= confirmed+1.  Rollbacks only ever target frames beyond the
        # confirmed frame, so these keys can never be re-advanced again.
        if frame in self._all_confirmed:
            return True
        return self._watermark != NULL_FRAME and frame_le(
            frame, frame_add(self._watermark, 1)
        )

    def final_frames(self) -> Dict[int, np.ndarray]:
        """The confirmed (replay-safe) portion of the recording."""
        return {f: v for f, v in self.frames.items() if self._is_final(f)}

    def __len__(self) -> int:
        return len(self.final_frames())

    # -- persistence --------------------------------------------------------

    def save(self, path: str) -> None:
        """Write the final (confirmed) frames to a compressed .npz file."""
        final = self.final_frames()
        keys = sorted(final)
        np.savez_compressed(
            path,
            frames=np.array(keys, np.int64),
            inputs=np.stack([final[k] for k in keys])
            if keys
            else np.zeros((0, self.num_players, *self.input_shape), self.input_dtype),
            statuses=np.stack([
                self.statuses.get(
                    k, np.full((self.num_players,), InputStatus.CONFIRMED,
                               np.int8)
                )
                for k in keys
            ])
            if keys
            else np.zeros((0, self.num_players), np.int8),
            num_players=self.num_players,
            input_shape=np.array(self.input_shape, np.int64),
            input_dtype=str(self.input_dtype),
            canonical_depth=self.canonical_depth or -1,
            canonical_branches=self.canonical_branches or -1,
        )

    @classmethod
    def load(cls, path: str) -> "InputRecorder":
        """Load a recording written by save()."""
        z = np.load(path, allow_pickle=False)
        cd = int(z["canonical_depth"]) if "canonical_depth" in z else -1
        cb = int(z["canonical_branches"]) if "canonical_branches" in z else -1
        rec = cls(
            int(z["num_players"]),
            tuple(int(x) for x in z["input_shape"]),
            np.dtype(str(z["input_dtype"])),
            canonical_depth=None if cd < 0 else cd,
            canonical_branches=None if cb < 0 else cb,
        )
        stats = z["statuses"] if "statuses" in z else None
        for i, (f, row) in enumerate(zip(z["frames"], z["inputs"])):
            rec.frames[int(f)] = row.astype(rec.input_dtype)
            if stats is not None:
                rec.statuses[int(f)] = stats[i].astype(np.int8)
            rec._all_confirmed.add(int(f))  # saved frames are final
        return rec


class ReplaySession:
    """Advance-only session feeding a recording (GGRS session surface)."""

    is_spectator = True  # drives the advance-only runner path

    def __init__(self, recording: InputRecorder, start_frame: Optional[int] = None):
        self.rec = recording
        self._frames = recording.final_frames()
        frames = sorted(self._frames)
        self.current_frame = start_frame if start_frame is not None else (
            frames[0] if frames else 0
        )
        self.end_frame = frames[-1] + 1 if frames else 0

    def num_players(self) -> int:
        return self.rec.num_players

    def max_prediction(self) -> int:
        return 0

    def confirmed_frame(self) -> int:
        return frame_add(self.current_frame, -1)

    def current_state(self):
        """Always RUNNING (no network)."""
        from .events import SessionState

        return SessionState.RUNNING

    @property
    def finished(self) -> bool:
        return self.current_frame >= self.end_frame

    def advance_frame(self) -> List:
        """Emit the next recorded frame as a confirmed Advance request."""
        if self.current_frame not in self._frames:
            raise PredictionThresholdError()  # gap or end of recording
        inputs = self._frames[self.current_frame]
        status = self.rec.statuses.get(
            self.current_frame,
            np.full((self.rec.num_players,), InputStatus.CONFIRMED, np.int8),
        )
        self.current_frame = frame_add(self.current_frame, 1)
        return [AdvanceRequest(inputs, status)]
