"""SyncTestSession — the determinism oracle.

Port of ``bevy_ggrs_tpu/session/synctest.py`` (semantics of bevy_ggrs
src/schedule_systems.rs:85-118,199-209): every ``advance_frame`` the session emits requests that
(1) save and advance the live frame, then (2) roll back ``check_distance``
frames and re-simulate to the present, saving each frame again.  Each frame
thus gets checksummed once live and ~check_distance more times from
progressively older snapshots; any disagreement raises
:class:`MismatchedChecksumError` on the next ``advance_frame`` (the runner
surfaces it as a SyncTestMismatch event).  Confirmed frame =
``current - check_distance`` (schedule_systems.rs:206-209).

Two changes from the JAX package: the automatic comparison cadence comes
from the world's device (:meth:`SyncTestSession.bind_device`: 1 on the CPU,
32 on CUDA) instead of a JAX backend query, and checksum providers are
plain callables (no readback queue).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..telemetry.metrics import registry
from ..utils.frames import NULL_FRAME, frame_add, frame_diff
from .events import InputStatus, InvalidRequestError, MismatchedChecksumError
from .requests import (
    AdvanceRequest,
    LoadRequest,
    RollbackCause,
    SaveCell,
    SaveRequest,
)


class SyncTestSession:
    """Continuous-resimulation determinism oracle (see module docstring)."""
    def __init__(
        self,
        num_players: int,
        input_shape=(),
        input_dtype=np.uint8,
        check_distance: int = 2,
        input_delay: int = 0,
        max_prediction: int = 8,
        initial_frame: int = 0,
        compare_interval: Optional[int] = None,
    ):
        self._num_players = num_players
        self.input_shape = tuple(input_shape)
        self.input_dtype = np.dtype(input_dtype)
        self.check_distance = int(check_distance)
        self.input_delay = int(input_delay)
        self._max_prediction = max(max_prediction, check_distance + 1)
        self.current_frame = initial_frame
        self._age = 0  # ticks since session start (rollback warmup gate)
        # Comparison cadence: forcing a checksum provider copies it from the
        # device and waits for the card.  Comparing every `compare_interval`
        # ticks lets the card run ahead between reads; detection is delayed by at
        # most that many ticks (the error still names the exact mismatched
        # frames).  None = auto: see bind_device.
        self._compare_interval = compare_interval
        self._ticks_since_compare = 0
        self._compares_run = 0  # see __del__ silent-oracle guard
        # frame -> [P, *shape] effective (post-delay) confirmed inputs
        self._inputs: Dict[int, np.ndarray] = {}
        self._staged: Dict[int, np.ndarray] = {}
        # frame -> list of (checksum provider | forced int)
        self._cells: Dict[int, List] = {}
        # frame -> entry count at last comparison (cells stay in _cells
        # after comparing — later resim saves must compare against history —
        # so pending_comparisons needs a watermark to tell compared apart)
        self._compared_len: Dict[int, int] = {}

    # -- GGRS session surface ---------------------------------------------

    def num_players(self) -> int:
        return self._num_players

    def max_prediction(self) -> int:
        return self._max_prediction

    def rollback_window(self) -> int:
        """Deepest rollback this session will ever request: every tick it
        rolls back exactly ``check_distance`` frames
        (schedule_systems.rs:85-118), regardless of ``max_prediction``."""
        return self.check_distance

    def confirmed_frame(self) -> int:
        """current - check_distance once the warmup window has passed."""
        if self.check_distance == 0:
            return self.current_frame
        if self._age < self.check_distance:
            return NULL_FRAME  # session too young to have confirmed anything
        return frame_add(self.current_frame, -self.check_distance)

    def add_local_input(self, handle: int, value) -> None:
        """Stage this tick's input for a handle."""
        if not (0 <= handle < self._num_players):
            raise InvalidRequestError(f"invalid player handle {handle}")
        arr = np.asarray(value, self.input_dtype).reshape(self.input_shape)
        self._staged[handle] = arr

    def advance_frame(self) -> List:
        """Emit save/advance plus the rollback-and-resimulate request batch."""
        if len(self._staged) != self._num_players:
            missing = set(range(self._num_players)) - set(self._staged)
            raise InvalidRequestError(f"missing local input for players {missing}")

        self._ticks_since_compare += 1
        if self._ticks_since_compare >= self.compare_interval():
            self._ticks_since_compare = 0
            self._check_mismatches()

        # apply input delay: input staged now takes effect at frame+delay;
        # frames before the first delayed input see the default (zero) input
        eff_frame = frame_add(self.current_frame, self.input_delay)
        packed = np.stack(
            [self._staged[h] for h in range(self._num_players)]
        ).astype(self.input_dtype)
        self._inputs[eff_frame] = packed
        self._staged.clear()

        f = self.current_frame
        status = np.full((self._num_players,), InputStatus.CONFIRMED, np.int8)
        requests: List = [
            SaveRequest(f, SaveCell(self, f)),
            AdvanceRequest(self._input_for(f), status),
        ]
        d = self.check_distance
        if d > 0 and self._age + 1 >= d:
            t = frame_add(f, 1 - d)
            # structural re-simulation, not a blamed peer: the cause tags
            # the oracle itself
            requests.append(LoadRequest(t, cause=RollbackCause(
                handle="resim", frame=t, lateness=d, mismatch=False,
                kind="resim",
            )))
            i = t
            while i != frame_add(f, 1):
                requests.append(AdvanceRequest(self._input_for(i), status))
                requests.append(SaveRequest(frame_add(i, 1), SaveCell(self, frame_add(i, 1))))
                i = frame_add(i, 1)
        self.current_frame = frame_add(f, 1)
        self._age += 1
        self._gc()
        return requests

    def bind_device(self, device) -> None:
        """Resolve the automatic comparison cadence for a world on
        ``device``: 1 on the CPU, where a checksum read is a memcpy, and 32
        on CUDA, where each read waits for the card.  An explicit
        ``compare_interval`` is kept."""
        if self._compare_interval is None:
            self._compare_interval = 1 if torch.device(device).type == "cpu" else 32

    def compare_interval(self) -> int:
        """Effective comparison cadence (1 until a device is bound)."""
        return self._compare_interval or 1

    def check_now(self) -> None:
        """Force all pending checksum comparisons immediately (raises
        :class:`MismatchedChecksumError` like ``advance_frame`` would).
        Call at session teardown when running with a deferred
        ``compare_interval``."""
        self._ticks_since_compare = 0
        self._check_mismatches()

    def pending_comparisons(self) -> int:
        """Frames with ≥2 saved checksums of which at least one arrived
        after the frame's last comparison (a nonzero value at teardown means
        the oracle has unchecked data — call :meth:`check_now` /
        ``runner.finish()``)."""
        return sum(
            1
            for f, entries in self._cells.items()
            if len(entries) >= 2
            and self._compared_len.get(f, 0) < len(entries)
        )

    def __del__(self):
        # Deferred comparison (compare_interval > 1, the CUDA default)
        # must not let a short run exit with the oracle silently unexercised:
        # a SyncTest that never compared anything proves nothing.
        try:
            if self._compares_run == 0 and self.pending_comparisons() > 0:
                import warnings

                warnings.warn(
                    "SyncTestSession dropped with NO checksum comparisons "
                    f"ever performed ({self.pending_comparisons()} frames "
                    "pending) — the determinism oracle never ran; call "
                    "runner.finish() or session.check_now() before teardown "
                    f"(compare_interval={self._compare_interval})",
                    RuntimeWarning,
                    stacklevel=1,
                )
        except Exception:
            pass  # interpreter teardown: modules may already be gone

    # -- internals ---------------------------------------------------------

    def _input_for(self, frame: int) -> np.ndarray:
        default = np.zeros((self._num_players, *self.input_shape), self.input_dtype)
        return self._inputs.get(frame, default)

    def _on_cell_saved(self, frame: int, provider) -> None:
        self._cells.setdefault(frame, []).append(provider)

    def _check_mismatches(self) -> None:
        mismatched = []
        for frame, entries in self._cells.items():
            if len(entries) < 2:
                continue
            # only a frame with >=2 checksums is a real comparison — a
            # vacuous sweep must not satisfy the __del__ silent-oracle guard
            self._compares_run += 1
            self._compared_len[frame] = len(entries)
            vals = set()
            for i, e in enumerate(entries):
                v = e() if callable(e) else e
                entries[i] = v  # memoize forced value
                if v is not None:
                    vals.add(v)
            if len(vals) > 1:
                mismatched.append(frame)
        if mismatched:
            frames = sorted(mismatched)
            reg = registry()
            if reg.enabled:
                reg.counter("checksum_mismatch_total",
                            "frames whose checksums disagreed").inc(len(frames),
                                                                    kind="synctest")
            for fr in frames:
                del self._cells[fr]
                self._compared_len.pop(fr, None)
            raise MismatchedChecksumError(self.current_frame, frames)

    def _gc(self) -> None:
        # a frame can still receive saves until current passes it by d+1;
        # cells additionally survive the deferred-comparison window so no
        # frame is ever dropped uncompared
        cell_horizon = frame_add(
            self.current_frame,
            -self.check_distance - 2 - self.compare_interval(),
        )
        for fr in [fr for fr in self._cells if frame_diff(fr, cell_horizon) < 0]:
            del self._cells[fr]
            self._compared_len.pop(fr, None)
        horizon = frame_add(self.current_frame, -self.check_distance - 2)
        for fr in [fr for fr in self._inputs if frame_diff(fr, horizon) < 0]:
            del self._inputs[fr]
