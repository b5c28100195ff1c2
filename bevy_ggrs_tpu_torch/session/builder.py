"""SessionBuilder — the fluent session construction surface.

Port of the SyncTest part of ``bevy_ggrs_tpu/session/builder.py``
(``with_num_players``, ``with_max_prediction_window``, ``with_input_delay``,
``with_check_distance``, ``start_synctest_session``); P2P and spectator
sessions come with a later slice."""

from __future__ import annotations

from typing import Tuple

import numpy as np

from .events import InvalidRequestError
from .synctest import SyncTestSession


class SessionBuilder:
    """Fluent session construction (see module docstring for the surface)."""

    def __init__(self, input_shape: Tuple[int, ...] = (), input_dtype=np.uint8):
        self.input_shape = tuple(input_shape)
        self.input_dtype = np.dtype(input_dtype)
        self._num_players = 2
        self._max_prediction = 8
        self._input_delay = 0
        self._check_distance = 2

    @classmethod
    def for_app(cls, app) -> "SessionBuilder":
        """Builder pre-filled with the app's input spec and player count."""
        b = cls(app.input_shape, app.input_dtype)
        b._num_players = app.num_players
        return b

    def with_num_players(self, n: int) -> "SessionBuilder":
        """Set the total player count (handles 0..n-1)."""
        if n < 1:
            raise InvalidRequestError("num_players must be >= 1")
        self._num_players = n
        return self

    def with_max_prediction_window(self, n: int) -> "SessionBuilder":
        """Frames the session may run ahead of confirmed inputs."""
        self._max_prediction = n
        return self

    def with_input_delay(self, n: int) -> "SessionBuilder":
        """Frames of local input delay."""
        self._input_delay = n
        return self

    def with_check_distance(self, n: int) -> "SessionBuilder":
        """SyncTest resimulation depth per tick."""
        self._check_distance = n
        return self

    def start_synctest_session(self) -> SyncTestSession:
        return SyncTestSession(
            num_players=self._num_players,
            input_shape=self.input_shape,
            input_dtype=self.input_dtype,
            check_distance=self._check_distance,
            input_delay=self._input_delay,
            max_prediction=self._max_prediction,
        )
