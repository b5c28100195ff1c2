"""Per-player input queues: delay, prediction, misprediction detection.

The ggrs-core surface reconstructed in SURVEY §2.3: inputs are delayed by
``input_delay`` frames at add time, remote inputs are predicted by repeating
the last confirmed input (``PredictRepeatLast``, bevy_ggrs src/lib.rs:59),
and the queue records every prediction it serves so the arrival of the real
input can report the *first incorrect frame* — the rollback target.

A copy of ``bevy_ggrs_tpu/session/input_queue.py``."""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from ..utils.frames import NULL_FRAME, frame_gt, frame_le, frame_lt
from .events import InputStatus


def predict_repeat_last(queue: "InputQueue", frame: int):
    """Default predictor: repeat the nearest earlier confirmed input
    (``PredictRepeatLast``, bevy_ggrs src/lib.rs:59), default input
    before the first real one."""
    if queue.last_confirmed == NULL_FRAME:
        return queue.default_input()
    if frame_le(frame, queue.last_confirmed):
        return queue._nearest_before(frame)
    return queue._inputs[queue.last_confirmed]


class InputQueue:
    """Per-player input queue: delay, prediction, misprediction tracking (see module docstring)."""
    def __init__(self, input_shape=(), input_dtype=np.uint8, delay: int = 0,
                 predictor=None):
        self.input_shape = tuple(input_shape)
        self.input_dtype = np.dtype(input_dtype)
        self.delay = int(delay)
        # the Config::InputPredictor analog: fn(queue, frame) -> input value
        self.predictor = predictor or predict_repeat_last
        self._inputs: Dict[int, np.ndarray] = {}  # frame -> effective input
        self.last_confirmed = NULL_FRAME  # newest frame with a real input
        self._predictions: Dict[int, np.ndarray] = {}  # frame -> served guess
        self.first_incorrect = NULL_FRAME
        # True when first_incorrect was set by a served-prediction/actual
        # disagreement; False when a disconnect-consensus truncation set it
        # structurally (session._adopt_disconnect).  Read alongside
        # take_first_incorrect() for rollback-cause attribution.
        self.first_incorrect_mismatch = False
        self._base: int | None = None  # first frame of the stream, if known

    def default_input(self) -> np.ndarray:
        return np.zeros(self.input_shape, self.input_dtype)

    # -- adding real inputs -------------------------------------------------

    def add_local(self, frame: int, value) -> int:
        """Add a local input at ``frame``; lands at ``frame + delay``.
        Returns the effective frame."""
        eff = frame + self.delay
        self._store(eff, np.asarray(value, self.input_dtype).reshape(self.input_shape))
        return eff

    def add_remote(self, frame: int, value) -> None:
        """Add a remote input already carrying its effective frame (the sender
        applied its own delay)."""
        self._store(frame, np.asarray(value, self.input_dtype).reshape(self.input_shape))

    def _store(self, frame: int, value: np.ndarray) -> None:
        if self.last_confirmed != NULL_FRAME and frame_le(frame, self.last_confirmed):
            return  # duplicate / redundancy (contiguity => already stored)
        if frame in self._inputs:
            return
        self._inputs[frame] = value
        # last_confirmed is the CONTIGUOUS high-water mark (anchored at the
        # stream base when known, else the first frame stored); out-of-order
        # arrivals (a lost chunk refilled later) park above it until the gap
        # closes
        if self.last_confirmed == NULL_FRAME:
            if self._base is not None and frame != self._base:
                return self._recheck_contig()  # parked until the base arrives
            self.last_confirmed = frame
        self._recheck_contig()
        served = self._predictions.pop(frame, None)
        if served is not None and not np.array_equal(served, value):
            if self.first_incorrect == NULL_FRAME or frame_lt(
                frame, self.first_incorrect
            ):
                self.first_incorrect = frame
                self.first_incorrect_mismatch = True

    def set_base(self, base: int) -> None:
        """Anchor the contiguity mark at the sender's first-ever frame."""
        self._base = base
        self._recheck_contig()

    def _recheck_contig(self) -> None:
        from ..utils.frames import frame_add

        if self.last_confirmed == NULL_FRAME and self._base is not None \
                and self._base in self._inputs:
            self.last_confirmed = self._base
        while self.last_confirmed != NULL_FRAME and \
                frame_add(self.last_confirmed, 1) in self._inputs:
            self.last_confirmed = frame_add(self.last_confirmed, 1)

    # -- reading ------------------------------------------------------------

    def input_for(self, frame: int) -> Tuple[np.ndarray, InputStatus]:
        """Input to use when advancing ``frame`` -> ``frame+1``.

        Confirmed if a real input exists; otherwise PredictRepeatLast, with
        the served guess recorded for later misprediction detection."""
        if frame in self._inputs:
            return self._inputs[frame], InputStatus.CONFIRMED
        pred = np.asarray(self.predictor(self, frame), self.input_dtype).reshape(
            self.input_shape
        )
        self._predictions[frame] = pred
        return pred, InputStatus.PREDICTED

    def _nearest_before(self, frame: int) -> np.ndarray:
        best, best_f = self.default_input(), None
        for f, v in self._inputs.items():
            if frame_lt(f, frame) and (best_f is None or frame_gt(f, best_f)):
                best, best_f = v, f
        return best

    def confirmed_input(self, frame: int) -> Optional[np.ndarray]:
        return self._inputs.get(frame)

    def take_first_incorrect(self) -> int:
        """Pop the earliest mispredicted frame (NULL_FRAME if none).
        ``first_incorrect_mismatch`` holds this pop's mismatch/structural
        flag until the next first_incorrect is recorded — callers read it
        immediately after popping (rollback-cause attribution)."""
        f = self.first_incorrect
        self.first_incorrect = NULL_FRAME
        return f

    def inputs_since(self, frame: int) -> list[tuple[int, np.ndarray]]:
        """All confirmed inputs with frame > ``frame``, ascending (for
        redundant INPUT packets)."""
        out = [(f, v) for f, v in self._inputs.items() if frame_gt(f, frame)]
        out.sort(key=lambda t: t[0])
        return out

    def truncate_after(self, frame: int) -> None:
        """Discard real inputs newer than ``frame`` and pull the contiguity
        mark back to it — the disconnect-frame consensus adoption: frames
        past the agreed point must resimulate under the disconnect policy
        even if we received more of the stream than other survivors did."""
        for g in [g for g in self._inputs if frame_gt(g, frame)]:
            del self._inputs[g]
        if self.last_confirmed != NULL_FRAME and frame_gt(
            self.last_confirmed, frame
        ):
            self.last_confirmed = (
                frame
                if frame != NULL_FRAME and frame in self._inputs
                else NULL_FRAME
            )
            self._recheck_contig()

    def gc(self, before_frame: int) -> None:
        """Drop inputs/predictions older than ``before_frame``."""
        for d in (self._inputs, self._predictions):
            for f in [f for f in d if frame_lt(f, before_frame)]:
                del d[f]
