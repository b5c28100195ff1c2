"""App — registration surface and device functions.

Port of ``bevy_ggrs_tpu/app.py``: collects the rollback registry
(components, resources, checksums, strategies), the user step function
(the ``GgrsSchedule`` contents) and the simulation constants (players, fps,
input spec), and builds the advance / resim / checksum functions on first
use.  The step is plain eager torch, run op by op, so every rollback depth
runs the same kernels and a SyncTest on one device is bit-identical at
every check distance.

The app owns a device: CUDA unless the caller passes ``device="cpu"``; with
no card and no explicit CPU request it raises.

Not in this slice: the packed, donated, speculate and branched functions.
"""

from __future__ import annotations

import dataclasses
from functools import cached_property
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from .ops.resim import (
    StepCtx,
    make_advance_fn,
    make_canonical_resim_fn,
    make_resim_fn,
)
from .snapshot.checksum import world_checksum
from .snapshot.strategy import CopyStrategy, Strategy
from .snapshot.world import Registry, WorldState
from .utils.device import DeviceLike, resolve_device
from .utils.frames import frame_add

DEFAULT_FPS = 60


class App:
    """Rollback application: registration surface + device functions."""

    def __init__(
        self,
        num_players: int = 2,
        capacity: int = 1024,
        fps: int = DEFAULT_FPS,
        input_shape: Tuple[int, ...] = (),
        input_dtype=np.uint8,
        retention: int = 16,
        canonical_depth: Optional[int] = None,
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        self.num_players = num_players
        self.fps = fps
        # despawn-retirement horizon (frames); must be >= the session's
        # rollback window (see ops/resim.py)
        self.retention = retention
        # run every advance through one fixed-length padded resim, as the
        # JAX package's canonical mode does; None = per-length resim
        self.canonical_depth = canonical_depth
        self.input_shape = tuple(input_shape)
        self.input_dtype = np.dtype(input_dtype)
        self.reg = Registry(capacity)
        self._step: Optional[Callable] = None
        self._setup: Optional[Callable] = None

    # -- registration (RollbackApp surface) --------------------------------

    def rollback_component(
        self,
        name: str,
        shape=(),
        dtype=torch.float32,
        default=None,
        checksum: bool = False,
        hash_fn=None,
        strategy: Strategy = CopyStrategy,
        required: bool = False,
    ) -> "App":
        """Register a component column for snapshot/rollback."""
        self.reg.register_component(
            name, shape, dtype, default, checksum, hash_fn, strategy, required
        )
        return self

    def rollback_resource(
        self,
        name: str,
        init,
        checksum: bool = False,
        hash_fn=None,
        present: bool = True,
        strategy: Strategy = CopyStrategy,
    ) -> "App":
        """Register a resource (tree of tensors) for snapshot/rollback."""
        self.reg.register_resource(name, init, checksum, hash_fn, present, strategy)
        return self

    def checksum_component(self, name: str, hash_fn=None) -> "App":
        """Enable checksumming for an already-registered component."""
        spec = self.reg.components[name]
        self.reg.components[name] = dataclasses.replace(
            spec, checksum=True, hash_fn=hash_fn or spec.hash_fn
        )
        return self

    def checksum_resource(self, name: str, hash_fn=None) -> "App":
        """Enable checksumming for an already-registered resource."""
        spec = self.reg.resources[name]
        self.reg.resources[name] = dataclasses.replace(
            spec, checksum=True, hash_fn=hash_fn or spec.hash_fn
        )
        return self

    def set_step(self, fn: Callable[[WorldState, StepCtx], WorldState]) -> "App":
        """Set the simulation step (the user's ``GgrsSchedule`` systems)."""
        self._step = fn
        for k in ("advance_fn", "resim_fn"):
            self.__dict__.pop(k, None)
        return self

    def set_setup(self, fn: Callable[[WorldState], WorldState]) -> "App":
        """Optional world-setup function run once at session start."""
        self._setup = fn
        return self

    # -- state -------------------------------------------------------------

    def init_state(self) -> WorldState:
        """Build the initial world on the app's device (runs the setup
        function if set; a lossy strategy's store/load round-trip too)."""
        w = self.reg.init_state(self.device)
        if self._setup is not None:
            w = self._setup(w)
        if not self.reg.is_identity_strategy():
            w = self.reg.load_state(self.reg.store_state(w))
        return w

    def zero_inputs(self) -> np.ndarray:
        return np.zeros((self.num_players, *self.input_shape), self.input_dtype)

    # -- device functions (built on first use) ------------------------------

    @property
    def step(self):
        """The registered step function (raises if set_step was never called)."""
        if self._step is None:
            raise RuntimeError("App.set_step was never called")
        return self._step

    @cached_property
    def advance_fn(self):
        """Single-frame advance ``fn(state, inputs, status, frame)`` ->
        ``(state, checksum)``; through the canonical resim when configured."""
        if self.canonical_depth is not None:
            resim = self.resim_fn

            def fn(state, inputs, status, frame, _unused=None):
                final, _, checks = resim(
                    state, torch.as_tensor(inputs)[None],
                    torch.as_tensor(status)[None], frame_add(int(frame), -1),
                )
                return final, checks[0]

            return fn
        return make_advance_fn(self.reg, self.step, self.fps, self.retention)

    @cached_property
    def resim_fn(self):
        """k-frame resim ``fn(state, inputs_seq, status_seq, start_frame)``
        -> ``(final, stacked, checksums)``."""
        if self.canonical_depth is not None:
            return make_canonical_resim_fn(
                self.reg, self.step, self.fps, self.retention, self.canonical_depth,
            )
        return make_resim_fn(self.reg, self.step, self.fps, self.retention)

    @cached_property
    def checksum_fn(self):
        """World checksum ``fn(world)`` -> ``[2]`` (hi, lo) u32 in int64."""
        return lambda w: world_checksum(self.reg, w)
