"""GgrsRunner — the schedule runner, synchronous core.

Port of the unpacked, synchronous core of ``bevy_ggrs_tpu/runner.py``
(the ``run_ggrs_schedules`` analog, bevy_ggrs src/schedule_systems.rs):
owns the fixed-timestep accumulator (run-slow x11/10 while the session is
ahead of its peers), polls remote clients every host tick, steps the
session, and serves its request stream.  A maximal
``[Load?] (Advance|Save)*`` run is one call of ``app.resim_fn``, which
returns every intermediate state and checksum: a rollback of depth N is one
resim, whose checksums come from one pass of the checksum fold kernel.
Frame ``i`` of the run is saved as a view of the stacked output plus a
:class:`~.snapshot.lazy.ChecksumRef` to its row, so a P2P session's desync
detection reads checksums through non-blocking copies and never blocks the
tick on the card.

This slice serves SyncTest, P2P (Python and native core) and spectator
sessions.  Not ported yet: pipelining, packed uploads, megastep,
speculation, tick coalescing, telemetry and forensics reports (a
``DesyncDetected`` is recorded in :attr:`GgrsRunner.events` only).
"""

from __future__ import annotations

from collections import Counter
from typing import Callable, Dict, List, Optional

import numpy as np

from .app import App
from .convert import to_numpy
from .ops.resim import slice_frame
from .session.events import (
    MismatchedChecksumError,
    NotSynchronizedError,
    PredictionThresholdError,
    SessionState,
)
from .session.requests import AdvanceRequest, GgrsRequest, LoadRequest, SaveRequest
from .session.synctest import SyncTestSession
from .snapshot.lazy import BatchChecks, ReadbackStats, wrap_single_checksum
from .snapshot.ring import SnapshotRing
from .snapshot.world import WorldState, active_mask
from .utils.frames import NULL_FRAME, frame_add


class GgrsRunner:
    """The schedule runner: fixed-timestep loop, session stepping, one
    resim per Advance/Save run (see module docstring)."""

    def __init__(
        self,
        app: App,
        session=None,
        read_inputs: Optional[Callable[[List[int]], Dict[int, np.ndarray]]] = None,
        on_event: Optional[Callable] = None,
        on_mismatch: Optional[Callable[[MismatchedChecksumError], None]] = None,
        initial_state: Optional[WorldState] = None,
        on_confirmed: Optional[Callable[[int], None]] = None,
    ):
        self.app = app
        self.read_inputs = read_inputs or (
            lambda handles: {h: app.zero_inputs()[h] for h in handles}
        )
        self.on_event = on_event  # every session event, as it is drained
        # a mismatch goes to on_mismatch; with none set it raises
        self.on_mismatch = on_mismatch
        self.on_confirmed = on_confirmed  # (frame) after each request batch
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
        # checksum reads of this runner's providers (peek misses, forced)
        self.readbacks = ReadbackStats()
        self._world_checksum = wrap_single_checksum(
            app.checksum_fn(self.world), self.readbacks)
        self.ring: SnapshotRing = SnapshotRing(depth=8)
        self.frame = 0  # RollbackFrameCount
        self.confirmed = NULL_FRAME  # ConfirmedFrameCount
        self.accumulator = 0.0
        self.run_slow = False
        self.local_players: List[int] = []
        self.events: List = []
        self.session = None
        # rollback frequency and depth: the rollback-netcode health metric
        self.rollbacks = 0
        self.rollback_frames = 0  # frames resimulated beyond each run's first
        self.rollbacks_by_cause: Counter = Counter()  # blamed handle -> loads
        self.resims = 0  # resim calls (each one checksum pass)
        self.stalled_frames = 0  # ticks skipped at the prediction threshold
        if session is not None:
            self.set_session(session)

    # -- session lifecycle ----------------------------------------------------

    def set_session(self, session) -> None:
        """Insert (or replace) the session; None resets runner state.  An
        outgoing session's deferred checksum comparisons are flushed first."""
        if session is not None and not hasattr(session, "advance_frame"):
            raise TypeError(f"GgrsRunner serves SyncTest, P2P and spectator "
                            f"sessions, not {type(session).__name__}")
        if self.session is not None and self.session is not session:
            self._flush_session_checks()
        self.session = session
        self.accumulator = 0.0
        self.run_slow = False
        self.local_players = []
        self.frame = 0
        self.confirmed = NULL_FRAME
        self.ring.clear()
        if session is None:
            return
        # despawn-retirement safety (ops/resim.py): slots hard-freed at
        # frame - retention must never lie inside the rollback window
        window = self._rollback_window(session)
        if self.app.retention < window:
            raise ValueError(
                f"App(retention={self.app.retention}) < session rollback "
                f"window ({window}): raise retention to at least the deepest "
                "rollback the session can request"
            )
        if hasattr(session, "bind_device"):
            session.bind_device(self.app.device)
        self.ring.set_depth(self._ring_depth(session))
        # sessions may start at a nonzero frame; the native core exposes
        # current_frame as a method
        cur = getattr(session, "current_frame", 0)
        self.frame = cur() if callable(cur) else cur

    @staticmethod
    def _rollback_window(session) -> int:
        if hasattr(session, "rollback_window"):
            return session.rollback_window()
        return session.max_prediction()

    def _ring_depth(self, session) -> int:
        """Snapshot-ring capacity: the deepest rollback window plus the
        saves one flush pushes before the end-of-flush confirm prunes."""
        return max(session.max_prediction(), self._rollback_window(session)) + 2

    def _flush_session_checks(self) -> None:
        """Force the session's deferred checksum comparisons."""
        if not hasattr(self.session, "check_now"):
            return
        try:
            self.session.check_now()
        except MismatchedChecksumError as e:
            self._report_mismatch(e)
        self._drain_events()

    def _report_mismatch(self, e: MismatchedChecksumError) -> None:
        if self.on_mismatch is None:
            raise e
        self.on_mismatch(e)

    def finish(self) -> None:
        """End-of-run hook: flush deferred checksum comparisons (a SyncTest
        with ``compare_interval`` > 1 would otherwise leave the last frames
        uncompared; a P2P session publishes and compares every confirmed
        interval frame whose copy is still in flight)."""
        if self.session is not None:
            self._flush_session_checks()

    # -- fixed-timestep loop --------------------------------------------------

    def update(self, delta_seconds: float) -> None:
        """One host tick: accumulate time, poll the network, run 0+ GGRS
        frames."""
        fps_delta = (1.0 / self.app.fps) * (1.1 if self.run_slow else 1.0)
        self.accumulator += delta_seconds
        if self.session is None:
            self.accumulator = 0.0
            return
        if hasattr(self.session, "poll_remote_clients"):
            self.session.poll_remote_clients()
            self._drain_events()
        while self.accumulator >= fps_delta:
            self.accumulator -= fps_delta
            if hasattr(self.session, "frames_ahead"):
                self.run_slow = self.session.frames_ahead() > 0
            requests = self._step_session()
            if requests:
                self._handle_requests(requests)
            fps_delta = (1.0 / self.app.fps) * (1.1 if self.run_slow else 1.0)

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

    # -- per-session-type steps -----------------------------------------------

    def _step_session(self) -> Optional[List[GgrsRequest]]:
        """One session tick: its request list, or None if the tick produced
        nothing (stall, handshake, mismatch)."""
        s = self.session
        if isinstance(s, SyncTestSession):
            return self._step_synctest()
        if getattr(s, "is_spectator", False):
            return self._step_spectator()
        return self._step_p2p()

    def _step_synctest(self) -> Optional[List[GgrsRequest]]:
        s = self.session
        self.local_players = list(range(s.num_players()))
        for handle, value in self.read_inputs(self.local_players).items():
            s.add_local_input(handle, value)
        try:
            return s.advance_frame()
        except MismatchedChecksumError as e:
            self._report_mismatch(e)
            return None

    def _step_p2p(self) -> Optional[List[GgrsRequest]]:
        s = self.session
        self.local_players = list(s.local_player_handles())
        if s.current_state() == SessionState.RUNNING:
            for handle, value in self.read_inputs(self.local_players).items():
                s.add_local_input(handle, value)
        try:
            requests = s.advance_frame()
        except PredictionThresholdError:
            self.stalled_frames += 1
            return None
        except NotSynchronizedError:
            return None  # still in the sync handshake; sim time does not advance
        self._drain_events()
        return requests

    def _step_spectator(self) -> Optional[List[GgrsRequest]]:
        s = self.session
        self.local_players = []
        if s.current_state() != SessionState.RUNNING:
            return None
        try:
            return s.advance_frame()
        except PredictionThresholdError:
            self.stalled_frames += 1  # waiting for the host's input
            return None
        except NotSynchronizedError:
            return None

    def _drain_events(self) -> None:
        """Move the session's pending events into :attr:`events` (a
        ``DesyncDetected`` among them is recorded there, with no forensics
        report) and hand each to ``on_event``."""
        if not hasattr(self.session, "events"):
            return
        for ev in self.session.events():
            self.events.append(ev)
            if self.on_event is not None:
                self.on_event(ev)

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
                self._service_rollback(load, requests[i + 1:j])
            else:
                self._run_batch(requests[i:j])
            i = j
        # prune after processing: a Load in this list may target a frame
        # below the confirmed frame it raised
        self.ring.confirm(self.confirmed)
        # fire after the batch: a corrective Load/Advance in the same list
        # must land before observers treat the frame as final
        if self.on_confirmed is not None and self.confirmed != NULL_FRAME:
            self.on_confirmed(self.confirmed)

    def _service_rollback(self, load: LoadRequest, run: List[GgrsRequest]) -> None:
        """A LoadRequest plus its following Advance/Save run: the miss path
        (no speculation cache), a ring load then one resim."""
        self._load(load.frame, load.cause)
        self._run_batch(run)

    def _load(self, frame: int, cause=None) -> None:
        """LoadGameState: restore the ring snapshot for ``frame``.  The
        rollback is counted against the handle ``cause`` blames
        (``"unknown"`` when the session names none), so
        :attr:`rollbacks_by_cause` sums to :attr:`rollbacks`."""
        self.rollbacks += 1
        blamed = cause.handle if cause is not None else None
        self.rollbacks_by_cause["unknown" if blamed is None else blamed] += 1
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
            self.resims += 1
            self.rollback_frames += k - 1
            final, stacked, cs = self.app.resim_fn(
                self.world,
                np.stack([a.inputs for a in adv]),
                np.stack([a.status for a in adv]),
                self.frame,
            )
            checks = BatchChecks(cs, self.readbacks)
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
