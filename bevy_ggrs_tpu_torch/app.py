"""App — registration surface and device functions.

Port of ``bevy_ggrs_tpu/app.py``: collects the rollback registry
(components, resources, checksums, strategies), the user step function
(the ``GgrsSchedule`` contents) and the simulation constants (players, fps,
input spec), and builds the advance / resim / checksum functions on first
use.  The step is plain eager torch, run op by op, so every rollback depth
runs the same kernels and a SyncTest on one device is bit-identical at
every check distance.

The app owns a device: CUDA unless the caller passes ``device="cpu"``; with
no card and no explicit CPU request it raises.  ``seed`` keys
``StepCtx.rng_key`` (``fold_in(PRNGKey(seed), frame)``, computed only when
a step reads it) and the models' own draws, as the JAX package's does.

Besides the plain functions it builds the packed single-upload resim
(``packed_spec``, ``packed_resim_fn``), the donating variants
(``resim_fn_donated``, ``packed_resim_fn_donated``) and the branch-axis
functions of speculation (``speculate_fn``, ``packed_speculate_fn``, and
``branched_fn`` under ``canonical_branches``), each ``None`` where the JAX
package's is: the donating ones in both canonical modes, the packed ones
under ``canonical_branches`` (``packed_speculate_fn`` in both).  The
single-frame ``advance_fn`` stages its row through pinned memory
(``utils/staging.py``) and runs the packed resim (the plain one, split
from the same upload, where there is no packed program).

``canonical_branches=B`` (with ``canonical_depth=K``) makes every resim
one fixed ``[B, K]`` branch-axis program (``ops/resim.py``
``make_canonical_branched_fn``): lane 0 carries the real inputs, and a
speculating runner fills the other lanes with hedges while a plain one
duplicates lane 0, so hedging and plain peers run the same program.
"""

from __future__ import annotations

import dataclasses
from functools import cached_property
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from .ops.packing import (
    PackedSpec,
    PackedUpload,
    pack_prefix,
    pack_row,
    prefix_words,
    repeat_last_row,
    unpack_seq,
)
from .ops.resim import (
    StepCtx,
    _as_input,
    make_canonical_branched_fn,
    make_canonical_resim_fn,
    make_packed_canonical_resim_fn,
    make_packed_resim_fn,
    make_packed_speculate_fn,
    make_resim_fn,
    make_speculate_fn,
    pad_repeat_last,
    select_branch,
    trim_frames,
)
from .snapshot.checksum import world_checksum
from .snapshot.strategy import CopyStrategy, Strategy
from .snapshot.world import Registry, WorldState
from .utils.device import DeviceLike, resolve_device
from .utils.frames import frame_add
from .utils.staging import StagingQueue

# the functions set_step invalidates
_STEP_FNS = ("advance_fn", "resim_fn", "resim_fn_donated", "packed_resim_fn",
             "packed_resim_fn_donated", "speculate_fn", "packed_speculate_fn",
             "branched_fn")

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
        canonical_branches: Optional[int] = None,
        device: DeviceLike = None,
        seed: int = 0,
    ):
        self.device = resolve_device(device)
        self.num_players = num_players
        self.fps = fps
        # session seed: StepCtx.rng_key is fold_in(PRNGKey(seed), frame)
        self.seed = seed
        # despawn-retirement horizon (frames); must be >= the session's
        # rollback window (see ops/resim.py)
        self.retention = retention
        # run every advance through one fixed-length padded resim, as the
        # JAX package's canonical mode does; None = per-length resim
        self.canonical_depth = canonical_depth
        # canonical-branched mode: the one program is also a fixed number of
        # branch lanes (lane 0 the real inputs, the others hedges or copies
        # of lane 0), so speculation runs inside it; the (depth, branches)
        # shape is then the same for every peer of a game
        self.canonical_branches = canonical_branches
        if canonical_branches is not None and canonical_depth is None:
            raise ValueError("canonical_branches requires canonical_depth")
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

    def register_hierarchy(self) -> "App":
        """Enable the parent-link (``ChildOf`` analog) component and
        recursive despawn (``snapshot/world.py``)."""
        self.reg.register_hierarchy()
        return self

    def set_step(self, fn: Callable[[WorldState, StepCtx], WorldState]) -> "App":
        """Set the simulation step (the user's ``GgrsSchedule`` systems)."""
        self._step = fn
        for k in _STEP_FNS:
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
        ``(state, checksum)`` from host ``inputs``/``status``: the row is
        packed into a pinned staging buffer, uploaded without a host wait
        and run through :attr:`packed_resim_fn` (the canonical program when
        configured), or split and run through :attr:`resim_fn` where there
        is no packed program (``canonical_branches``)."""
        spec, resim = self.packed_spec, self.packed_resim_fn
        plain = self.resim_fn if resim is None else None
        rows = 1 if resim is None else self.canonical_depth or 1
        stage = StagingQueue(lambda: spec.new_buffer(rows), device=self.device)

        def fn(state, inputs, status, frame, _unused=None):
            buf = stage.acquire()
            pack_prefix(buf, frame_add(int(frame), -1), 1)
            pack_row(spec, buf, 0, inputs, status)
            repeat_last_row(buf, 1, rows)
            packed = PackedUpload(stage.commit(buf), *prefix_words(buf))
            if plain is not None:
                final, _, checks = plain(state, *unpack_seq(spec, packed.rows),
                                         packed.start_frame)
            else:
                final, _, checks = resim(state, packed)
            return final, checks[0]

        return fn

    @cached_property
    def resim_fn(self):
        """k-frame resim ``fn(state, inputs_seq, status_seq, start_frame)``
        -> ``(final, stacked, checksums)``; inputs and statuses on the app's
        device.  Under ``canonical_branches`` it is the facade over
        :attr:`branched_fn`: lane 0 carries the inputs, the other lanes
        duplicate it, and lane 0's output comes back trimmed to k frames."""
        if self.canonical_branches is not None:
            return self._branched_resim_wrapper()
        if self.canonical_depth is not None:
            return make_canonical_resim_fn(
                self.reg, self.step, self.fps, self.retention, self.canonical_depth,
                seed=self.seed,
            )
        return make_resim_fn(self.reg, self.step, self.fps, self.retention, seed=self.seed)

    @cached_property
    def resim_fn_donated(self):
        """Donating :attr:`resim_fn`: the passed state object is dead after
        the call (the sanitizer flags a later dispatch of it); no storage is
        reused, so the results are the plain call's.  Callers donate only a
        state nothing else will dispatch (the runner tracks this).  ``None``
        in both canonical modes, as in the JAX package: there every call
        runs the one fixed-length program."""
        if self.canonical_depth is not None:
            return None
        return make_resim_fn(self.reg, self.step, self.fps, self.retention,
                             donate=True, seed=self.seed)

    # -- packed single-upload functions (ops/packing.py) ---------------------

    @cached_property
    def packed_spec(self) -> PackedSpec:
        """Static packed-buffer layout for this app's input spec."""
        return PackedSpec.for_app(self)

    @cached_property
    def packed_resim_fn(self):
        """Single-upload resim ``fn(state, packed: PackedUpload)`` ->
        ``(final, stacked, checks)``: inputs and statuses ride one
        ``int8[k + 1, W]`` upload, split on the card.  Canonical apps get
        the fixed-length program, whose stacked states and checksums come
        back untrimmed at ``canonical_depth`` rows.  ``None`` under
        ``canonical_branches``: the branched program keeps its own
        ``[B, K]`` shape, and the runner stages it itself."""
        if self.canonical_branches is not None:
            return None
        if self.canonical_depth is not None:
            return make_packed_canonical_resim_fn(
                self.reg, self.step, self.packed_spec, self.fps, self.retention,
                self.canonical_depth, seed=self.seed,
            )
        return make_packed_resim_fn(self.reg, self.step, self.packed_spec,
                                    self.fps, self.retention, seed=self.seed)

    @cached_property
    def packed_resim_fn_donated(self):
        """Donating :attr:`packed_resim_fn` (the contract of
        :attr:`resim_fn_donated`); ``None`` in canonical mode."""
        if self.canonical_depth is not None:
            return None
        return make_packed_resim_fn(self.reg, self.step, self.packed_spec,
                                    self.fps, self.retention, donate=True, seed=self.seed)

    # -- the branch axis (speculation, ops/resim.py) ----------------------------

    @cached_property
    def speculate_fn(self):
        """M input branches from one state in one call: ``fn(state,
        inputs[M, k, P, ...], status[M, k, P], start_frame)`` -> ``(finals
        [M], stacked [M, k], checks [M, k, 2])``."""
        return make_speculate_fn(self.reg, self.step, self.fps, self.retention,
                                 seed=self.seed)

    @cached_property
    def packed_speculate_fn(self):
        """Single-upload :attr:`speculate_fn`: ``fn(state, packed)`` with the
        lanes in one ``int8[M, depth + 1, W]`` upload.  ``None`` in both
        canonical modes (the runner refuses a plain speculation cache there,
        and the branched mode hedges inside its own program)."""
        if self.canonical_depth is not None:
            return None
        return make_packed_speculate_fn(self.reg, self.step, self.packed_spec,
                                        self.fps, self.retention, seed=self.seed)

    @cached_property
    def branched_fn(self):
        """The canonical-branched program (``canonical_branches`` mode):
        ``fn(state, inputs[B, K, P, ...], status[B, K, P], start_frame,
        n_real[B])`` -> per-lane ``(finals, stacked, checks)``."""
        if self.canonical_branches is None:
            raise RuntimeError("App was not configured with canonical_branches")
        return make_canonical_branched_fn(
            self.reg, self.step, self.fps, self.retention, self.canonical_depth,
            self.canonical_branches, seed=self.seed,
        )

    def _branched_resim_wrapper(self):
        """resim_fn facade over the branched program: lane 0 carries the
        real inputs and the other lanes duplicate it (dummy hedges), so a
        peer that does not speculate runs the same program as one that
        does."""
        fn = self.branched_fn
        lanes, depth = self.canonical_branches, self.canonical_depth

        def wrapped(state, inputs_seq, status_seq, start_frame, _unused=None):
            inputs_seq = _as_input(inputs_seq, self.device)
            status_seq = _as_input(status_seq, self.device)
            k = inputs_seq.shape[0]
            if k > depth:
                raise ValueError(f"resim depth {k} exceeds canonical_depth {depth}")
            pad = depth - k
            ib = pad_repeat_last(inputs_seq, pad)
            sb = pad_repeat_last(status_seq, pad)
            finals, stacked, checks = fn(
                state, ib[None].expand(lanes, *ib.shape),
                sb[None].expand(lanes, *sb.shape), start_frame, [k] * lanes)
            stacked, checks = trim_frames((stacked, checks), k, axis=1)
            return select_branch((finals, stacked, checks), 0)

        return wrapped

    @cached_property
    def checksum_fn(self):
        """World checksum ``fn(world)`` -> ``[2]`` (hi, lo) u32 in int64."""
        return lambda w: world_checksum(self.reg, w)
