"""The one traffic generator: each pad's inputs, frame by frame.

A traffic file (``traffic/<name>.json``) fixes when each pad's input
changes (``change_every``: one period in frames per player handle, 0 for a
pad that holds its input).  The seed draws only the values: each change
takes a new byte that differs from the last, so every scheduled change of
a remote pad is a misprediction, whichever values are drawn.  The game
(which frames change, and so the rollbacks) is the traffic file's, the
same for every seed.
"""

from __future__ import annotations

import numpy as np

_CHUNK = 4096


class PadInputs:
    """The input of pad ``handle`` of game ``match`` at each frame."""

    def __init__(self, seed: int, match: int, handle: int, every: int):
        self.every = int(every)
        self._rng = np.random.default_rng([int(seed) % (1 << 64), int(match), int(handle)])
        first = int(self._rng.integers(0, 256))
        self._values = np.array([first], np.int64)

    def _grow(self, upto: int) -> None:
        while len(self._values) <= upto:
            # a step of 1..255 modulo 256: never the value before
            steps = self._rng.integers(1, 256, _CHUNK)
            nxt = (self._values[-1] + np.cumsum(steps)) % 256
            self._values = np.concatenate([self._values, nxt])

    def at(self, frame: int) -> np.uint8:
        c = frame // self.every if self.every else 0
        if c >= len(self._values):
            self._grow(c)
        return np.uint8(self._values[c])


def pads(seed: int, match: int, traffic: dict) -> list:
    """One :class:`PadInputs` per player handle of game ``match``."""
    return [PadInputs(seed, match, h, every)
            for h, every in enumerate(traffic["change_every"])]
