"""GgrsRunner — the schedule runner, synchronous core.

Port of the unpacked, synchronous core of ``bevy_ggrs_tpu/runner.py``
(the ``run_ggrs_schedules`` analog, bevy_ggrs src/schedule_systems.rs):
owns the fixed-timestep accumulator, steps the session, and serves its
request stream.  A maximal ``[Load?] (Advance|Save)*`` run is one call of
``app.resim_fn``, which returns every intermediate state and checksum: a
rollback of depth N is one resim, whose checksums come from one pass of
the checksum fold kernel.  Frame ``i`` of the run is saved as a view of
the stacked output plus its checksum row, and checksums reach the session
as providers that copy the run's ``[k, 2]`` checksums to the host once,
when the session first needs one.

This slice serves SyncTest sessions.  Not ported yet: pipelining, packed
uploads, megastep, speculation, P2P and spectator sessions, telemetry.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from .app import App
from .convert import to_numpy
from .ops.resim import slice_frame
from .session.events import MismatchedChecksumError
from .session.requests import AdvanceRequest, GgrsRequest, LoadRequest, SaveRequest
from .session.synctest import SyncTestSession
from .snapshot.ring import SnapshotRing
from .snapshot.world import WorldState, active_mask
from .utils.frames import NULL_FRAME, frame_add


class _BatchChecks:
    """The ``[k, 2]`` checksums of one resim.  The first read copies all k
    rows to the host at once; later reads are host lookups."""

    def __init__(self, checks: torch.Tensor):
        self._device = checks
        self._host: Optional[list] = None

    def value(self, i: int) -> int:
        if self._host is None:
            self._host = self._device.tolist()
            self._device = None
        hi, lo = self._host[i]
        return (hi << 32) | lo

    def ref(self, i: int) -> Callable[[], int]:
        """A checksum provider for row ``i``."""
        return partial(self.value, i)


class GgrsRunner:
    """The schedule runner: fixed-timestep loop, session stepping, one
    resim per Advance/Save run (see module docstring)."""

    def __init__(
        self,
        app: App,
        session=None,
        read_inputs: Optional[Callable[[List[int]], Dict[int, np.ndarray]]] = None,
        on_mismatch: Optional[Callable[[MismatchedChecksumError], None]] = None,
        initial_state: Optional[WorldState] = None,
    ):
        self.app = app
        self.read_inputs = read_inputs or (
            lambda handles: {h: app.zero_inputs()[h] for h in handles}
        )
        # a mismatch goes to on_mismatch; with none set it raises
        self.on_mismatch = on_mismatch
        if initial_state is None:
            self.world = app.init_state()
        else:
            if initial_state.device != app.device:
                raise ValueError(
                    f"initial_state lies on {initial_state.device}, the app "
                    f"on {app.device}"
                )
            self.world = initial_state
            if not app.reg.is_identity_strategy():
                # the frame-0 snapshot must restore exactly the live state
                self.world = app.reg.load_state(app.reg.store_state(self.world))
        self._world_checksum = _BatchChecks(app.checksum_fn(self.world)[None]).ref(0)
        self.ring: SnapshotRing = SnapshotRing(depth=8)
        self.frame = 0  # RollbackFrameCount
        self.confirmed = NULL_FRAME  # ConfirmedFrameCount
        self.accumulator = 0.0
        self.session = None
        # rollback frequency and depth: the rollback-netcode health metric
        self.rollbacks = 0
        self.rollback_frames = 0  # frames resimulated beyond each run's first
        if session is not None:
            self.set_session(session)

    # -- session lifecycle ----------------------------------------------------

    def set_session(self, session) -> None:
        """Insert (or replace) the session; None resets runner state.  An
        outgoing session's deferred comparisons are flushed first."""
        if session is not None and not isinstance(session, SyncTestSession):
            raise TypeError(
                "this runner serves SyncTest sessions; P2P and spectator "
                "sessions are not ported yet"
            )
        if self.session is not None and self.session is not session:
            self._flush_session_checks()
        self.session = session
        self.accumulator = 0.0
        self.frame = 0
        self.confirmed = NULL_FRAME
        self.ring.clear()
        if session is None:
            return
        # despawn-retirement safety (ops/resim.py): slots hard-freed at
        # frame - retention must never lie inside the rollback window
        window = session.rollback_window()
        if self.app.retention < window:
            raise ValueError(
                f"App(retention={self.app.retention}) < session rollback "
                f"window ({window}): raise retention to at least the deepest "
                "rollback the session can request"
            )
        session.bind_device(self.app.device)
        self.ring.set_depth(self._ring_depth(session))
        self.frame = session.current_frame

    def _ring_depth(self, session) -> int:
        """Snapshot-ring capacity: the deepest rollback window plus the
        saves one flush pushes before the end-of-flush confirm prunes."""
        return max(session.max_prediction(), session.rollback_window()) + 2

    def _flush_session_checks(self) -> None:
        """Force the session's deferred checksum comparisons."""
        try:
            self.session.check_now()
        except MismatchedChecksumError as e:
            self._report_mismatch(e)

    def _report_mismatch(self, e: MismatchedChecksumError) -> None:
        if self.on_mismatch is None:
            raise e
        self.on_mismatch(e)

    def finish(self) -> None:
        """End-of-run hook: flush deferred checksum comparisons (a SyncTest
        with ``compare_interval`` > 1 would otherwise leave the last frames
        uncompared)."""
        if self.session is not None:
            self._flush_session_checks()

    # -- fixed-timestep loop --------------------------------------------------

    def update(self, delta_seconds: float) -> None:
        """One host tick: accumulate time, run 0+ GGRS frames."""
        fps_delta = 1.0 / self.app.fps
        self.accumulator += delta_seconds
        if self.session is None:
            self.accumulator = 0.0
            return
        while self.accumulator >= fps_delta:
            self.accumulator -= fps_delta
            requests = self._step_synctest()
            if requests:
                self._handle_requests(requests)

    def tick(self) -> None:
        """Run exactly one GGRS frame."""
        self.update(1.0 / self.app.fps)

    @property
    def checksum(self) -> int:
        """Current world checksum as the 64-bit cross-peer value (waits for
        the card)."""
        return self._world_checksum()

    def read_components(self, names=None) -> dict:
        """Component columns, presence masks (``__has_<name>__``) and the
        active mask (``__active__``) as host numpy arrays."""
        names = list(names) if names is not None else list(self.app.reg.components)
        out = {n: to_numpy(self.world.comps[n]) for n in names}
        for n in names:
            out[f"__has_{n}__"] = to_numpy(self.world.has[n])
        out["__active__"] = to_numpy(active_mask(self.world))
        return out

    # -- session step ---------------------------------------------------------

    def _step_synctest(self) -> Optional[List[GgrsRequest]]:
        s = self.session
        for handle, value in self.read_inputs(list(range(s.num_players()))).items():
            s.add_local_input(handle, value)
        try:
            return s.advance_frame()
        except MismatchedChecksumError as e:
            self._report_mismatch(e)
            return None

    # -- request dispatch -----------------------------------------------------

    def _handle_requests(self, requests: List[GgrsRequest]) -> None:
        s = self.session
        self.ring.set_depth(self._ring_depth(s))
        self.confirmed = s.confirmed_frame()
        i, n = 0, len(requests)
        while i < n:
            load = requests[i] if isinstance(requests[i], LoadRequest) else None
            j = i + 1 if load is not None else i
            while j < n and isinstance(requests[j], (AdvanceRequest, SaveRequest)):
                j += 1
            if load is not None:
                # rollback servicing (the miss path: no speculation cache)
                self._load(load.frame)
                self._run_batch(requests[i + 1:j])
            else:
                self._run_batch(requests[i:j])
            i = j
        # prune after processing: a Load in this list may target a frame
        # below the confirmed frame it raised
        self.ring.confirm(self.confirmed)

    def _load(self, frame: int) -> None:
        """LoadGameState: restore the ring snapshot for ``frame``."""
        self.rollbacks += 1
        stored, checksum = self.ring.rollback(frame)
        self.world = self.app.reg.load_state(stored)
        self._world_checksum = checksum
        self.frame = frame

    def _run_batch(self, run: List[GgrsRequest]) -> None:
        """Serve a maximal Advance/Save run with one resim call."""
        adv = [r for r in run if isinstance(r, AdvanceRequest)]
        k = len(adv)
        pre_world, pre_checksum = self.world, self._world_checksum
        stacked = checks = None
        if k:
            self.rollback_frames += k - 1
            final, stacked, cs = self.app.resim_fn(
                self.world,
                np.stack([a.inputs for a in adv]),
                np.stack([a.status for a in adv]),
                self.frame,
            )
            checks = _BatchChecks(cs)
            self.world = final
            self._world_checksum = checks.ref(k - 1)
            self.frame = frame_add(self.frame, k)
        identity = self.app.reg.is_identity_strategy()
        c = 0  # advances seen so far within the run
        for r in run:
            if isinstance(r, AdvanceRequest):
                c += 1
                continue
            if c == 0:
                state, cs_ref = pre_world, pre_checksum
            else:
                state, cs_ref = slice_frame(stacked, c - 1), checks.ref(c - 1)
            stored = state if identity else self.app.reg.store_state(state)
            self.ring.push(r.frame, (stored, cs_ref))
            r.cell.save(r.frame, cs_ref)
