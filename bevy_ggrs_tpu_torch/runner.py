"""GgrsRunner — the schedule runner.

Port of ``bevy_ggrs_tpu/runner.py`` (the ``run_ggrs_schedules`` analog,
bevy_ggrs src/schedule_systems.rs): owns the fixed-timestep accumulator
(run-slow x11/10 while the session is ahead of its peers), polls remote
clients every host tick, steps the session, and serves its request
stream.  A maximal ``[Load?] (Advance|Save)*`` run is one resim call, which
returns every intermediate state and checksum: a rollback of depth N is one
resim, whose checksums come from one pass of the checksum fold kernel.
Frame ``i`` of the run is saved as a :class:`~.snapshot.lazy.LazySlice` of
the stacked output plus a :class:`~.snapshot.lazy.ChecksumRef` to its row.

The default dispatch path is the JAX runner's:

- ``pipeline=True``: each resim's checksum copy to pinned host memory
  starts at dispatch (:class:`~.snapshot.lazy.ReadbackQueue`) and landed
  copies are harvested at the top of the next ``update``, so no tick
  waits for the card.  ``pipeline=False`` is the synchronous baseline:
  every tick that ran requests ends by reading its checksums and waiting
  for the card.
- ``packed`` (on whenever the app has a packed program): a resim's inputs
  and statuses ride ONE ``int8[k + 1, W]`` upload from a pinned staging
  buffer (``ops/packing.py``, ``utils/staging.py``), fenced by a CUDA
  event, never by a host wait; the unpacked path uploads inputs and
  statuses as two pinned copies.  ``input_queue=True`` rotates two packed
  staging buffers instead of one.
- donation (``enable_donation``): when the caller does not hold the live
  world (``_world_donatable``), the dispatch donates it: the world object
  is dead after the resim (the sanitizer flags a later dispatch of it).
  Eager torch allocates the final world fresh, so donation drops the
  reference and writes no storage; a snapshot that shares the donated
  world's tensors stays valid.
- ``ring_materialize_bytes``: a resim whose stacked output exceeds it
  (64 MiB) has its saves cloned out of it, so the ring holds single frames
  instead of pinning whole stacks (counted in ``materialized_saves``).
- ``coalesce_frames=N``: an update that owes several frames flushes up to
  N ticks' requests through one request pass, so consecutive advances
  fuse into one resim.

It serves SyncTest, P2P (Python and native core) and spectator sessions.
Not ported yet: megastep, speculation, telemetry and forensics reports (a
``DesyncDetected`` is recorded in :attr:`GgrsRunner.events` only).
"""

from __future__ import annotations

import dataclasses
from collections import Counter
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from .app import App
from .convert import to_numpy
from .ops.packing import PackedUpload, pack_prefix, pack_row, prefix_words, repeat_last_row
from .session.events import (
    MismatchedChecksumError,
    NotSynchronizedError,
    PredictionThresholdError,
    SessionState,
)
from .session.requests import AdvanceRequest, GgrsRequest, LoadRequest, SaveRequest
from .session.synctest import SyncTestSession
from .snapshot.lazy import (
    BatchChecks,
    LazySlice,
    ReadbackStats,
    materialize,
    readback_queue,
    tree_index,
    wrap_single_checksum,
)
from .snapshot.ring import SnapshotRing
from .snapshot.world import WorldState, active_mask
from .utils import staging
from .utils.frames import NULL_FRAME, frame_add
from .utils.mem import tree_device_bytes
from .utils.staging import StagingBuffer, StagingQueue


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
        coalesce_frames: int = 1,
        pipeline: bool = True,
        packed: Optional[bool] = None,
        input_queue: bool = False,
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
        # Tick coalescing: an update that owes N > 1 frames flushes up to
        # coalesce_frames ticks' requests through one _handle_requests, so
        # consecutive advances fuse into one k=N resim; 1 = every tick.
        if coalesce_frames < 1:
            raise ValueError("coalesce_frames must be >= 1")
        self.coalesce_frames = coalesce_frames
        # rollback frequency and depth: the rollback-netcode health metric
        self.ticks = 0  # session ticks stepped
        self.rollbacks = 0
        self.rollback_frames = 0  # frames resimulated beyond each run's first
        self.rollbacks_by_cause: Counter = Counter()  # blamed handle -> loads
        self.resims = 0  # resim calls (each one checksum pass)
        self.donated_dispatches = 0  # resims that donated the input world
        self.stalled_frames = 0  # ticks skipped at the prediction threshold
        # Ring memory guard: a lazy save pins its whole [k, ...] stacked
        # output while it is ringed.  Above this stacked size the saves are
        # cloned out (one device copy per save), bounding the ring to one
        # world per saved frame.
        self.ring_materialize_bytes = 64 * 2**20
        self.materialized_saves = 0
        self._stacked_bytes_by_k: Dict[int, int] = {}
        # Donation: safe when no caller holds the live world object — False
        # at init (the caller may hold the initial state) and after a caller
        # assigns ``world``; True after a resim or a load, whose world
        # object only the runner has seen.
        self.enable_donation = True
        self._world_donatable = False
        # the last resim's stacked output, kept while the ring's lazy saves
        # pin it anyway, to count loads that read it (pipeline_degrades)
        self._last_stacked = None
        # Tick pipelining: checksum copies start at dispatch and are
        # harvested next update; pipeline=False drains every tick.
        self.pipeline = bool(pipeline)
        self._rbq = readback_queue()
        self.pipeline_degrades = 0  # loads that targeted the last resim's output
        # Packed single upload: tri-state.  None turns it on whenever the
        # app has a packed program; an explicit True without one raises.
        if packed is None:
            self.packed = app.packed_resim_fn is not None
        else:
            self.packed = bool(packed)
            if self.packed and app.packed_resim_fn is None:
                raise ValueError(
                    "packed=True but the app has no packed program; pass "
                    "packed=None to fall back to the two-upload path"
                )
        self.input_queue = bool(input_queue)
        if self.input_queue and not self.packed:
            raise ValueError(
                "input_queue rotates the packed staging buffer and so requires "
                "the packed upload path; enable packed (or drop input_queue)"
            )
        # pinned staging, sized lazily and grown geometrically
        self._stage_inputs: Optional[StagingBuffer] = None
        self._stage_status: Optional[StagingBuffer] = None
        self._stage_cap = 0
        self._stage_packed: Optional[StagingBuffer] = None
        self._packed_queue: Optional[StagingQueue] = None
        self._packed_cap = 0
        # upload census: host-to-device copies issued by resims, and the
        # bytes staged through packed buffers
        self.host_uploads = 0
        self.packed_upload_bytes = 0
        if session is not None:
            self.set_session(session)

    # -- live world access ----------------------------------------------------

    @property
    def world(self) -> WorldState:
        """The live world.  Assigning to it marks it non-donatable: the
        caller may still hold its tensors."""
        return self._world

    @world.setter
    def world(self, value: WorldState) -> None:
        self._world = value
        self._world_donatable = False

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
        self._last_stacked = None
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
        if (self.app.canonical_depth is not None
                and self.coalesce_frames + window > self.app.canonical_depth):
            # a rollback in the same coalesced flush as catch-up ticks fuses
            # a (window + coalesce)-long run the canonical program cannot pad
            raise ValueError(
                f"coalesce_frames ({self.coalesce_frames}) + rollback window "
                f"({window}) exceeds canonical_depth ({self.app.canonical_depth}); "
                "lower coalesce_frames or raise App(canonical_depth=...)"
            )
        if isinstance(session, SyncTestSession):
            horizon = session.check_distance + session.compare_interval() + 2
            if self.coalesce_frames > horizon:
                # the session collects comparison cells this many frames back
                # each advance: a deeper flush would skip comparisons silently
                raise ValueError(
                    f"coalesce_frames ({self.coalesce_frames}) exceeds the SyncTest "
                    f"comparison-cell horizon (check_distance + compare_interval "
                    f"+ 2 = {horizon}); lower coalesce_frames or raise "
                    "check_distance/compare_interval"
                )
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
        """Snapshot-ring capacity: the deepest rollback window plus every
        save a maximally coalesced flush pushes before the end-of-flush
        confirm prunes."""
        window = max(session.max_prediction(), self._rollback_window(session))
        return window + 1 + self.coalesce_frames

    def _flush_session_checks(self) -> None:
        """Force the session's deferred checksum comparisons."""
        if not hasattr(self.session, "check_now"):
            return
        # copies that already landed are read first, not forced
        self._rbq.harvest()
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
        if self.pipeline:
            # last tick's landed checksum copies, before the poll, so the
            # session publishes them this tick without waiting for the card
            self._rbq.harvest()
        if hasattr(self.session, "poll_remote_clients"):
            self.session.poll_remote_clients()
            self._drain_events()
        pending: List[GgrsRequest] = []
        pending_ticks = 0
        ran_requests = False
        while self.accumulator >= fps_delta:
            self.accumulator -= fps_delta
            if hasattr(self.session, "frames_ahead"):
                self.run_slow = self.session.frames_ahead() > 0
            requests = self._step_session()
            if requests:
                pending.extend(requests)
                pending_ticks += 1
                if pending_ticks >= self.coalesce_frames:
                    self._handle_requests(pending)
                    pending, pending_ticks = [], 0
                    ran_requests = True
            fps_delta = (1.0 / self.app.fps) * (1.1 if self.run_slow else 1.0)
        if pending:
            self._handle_requests(pending)
            ran_requests = True
        if ran_requests and not self.pipeline:
            # synchronous mode: retire this tick's device work (world and
            # checksum readbacks) before the update returns
            self._drain_inflight()

    def tick(self) -> None:
        """Run exactly one GGRS frame."""
        self.update(1.0 / self.app.fps)

    def _drain_inflight(self) -> None:
        """Read the checksums in flight and wait until the live world's
        resim has finished: the one blocking point, for flush points and
        the synchronous mode."""
        if self.pipeline:
            self._rbq.harvest()
        else:
            # this runner's batches only: forced reads, counted as such
            BatchChecks.pull_pending(self.readbacks)
        if self.app.device.type == "cuda":
            torch.cuda.current_stream(self.app.device).synchronize()

    @property
    def checksum(self) -> int:
        """Current world checksum as the 64-bit cross-peer value (waits for
        the card unless its copy has landed)."""
        if self.pipeline:
            self._rbq.harvest()
        return self._world_checksum()

    def read_components(self, names=None) -> dict:
        """Component columns, presence masks (``__has_<name>__``) and the
        active mask (``__active__``) as host numpy arrays, after the
        in-flight resim has finished."""
        self._drain_inflight()
        names = list(names) if names is not None else list(self.app.reg.components)
        out = {n: to_numpy(self.world.comps[n]) for n in names}
        for n in names:
            out[f"__has_{n}__"] = to_numpy(self.world.has[n])
        out["__active__"] = to_numpy(active_mask(self.world))
        return out

    def _staging(self) -> list:
        return [s for s in (self._stage_inputs, self._stage_status,
                            self._stage_packed, self._packed_queue) if s is not None]

    def stats(self) -> dict:
        """Runner health counters (rollback frequency and depth, resims,
        uploads, donation, the pipeline's degradations, staging waits)."""
        return {
            "overflow": bool(self.world.overflow),
            "ticks": self.ticks,
            "rollbacks": self.rollbacks,
            "resimulated_frames": self.rollback_frames,
            "device_dispatches": self.resims,
            "donated_dispatches": self.donated_dispatches,
            "host_uploads": self.host_uploads,
            "packed": self.packed,
            "packed_upload_bytes": self.packed_upload_bytes,
            "materialized_saves": self.materialized_saves,
            "stalled_frames": self.stalled_frames,
            "input_queue": self.input_queue,
            "staging_deferred_blocks": sum(s.deferred_blocks for s in self._staging()),
            "staging_landed_free": sum(s.landed_free for s in self._staging()),
            "readbacks": dataclasses.asdict(self.readbacks),
            "frame": self.frame,
            "confirmed": self.confirmed,
            "pipeline": self.pipeline,
            "pipeline_degrades": self.pipeline_degrades,
        }

    # -- per-session-type steps -----------------------------------------------

    def _step_session(self) -> Optional[List[GgrsRequest]]:
        """One session tick: its request list, or None if the tick produced
        nothing (stall, handshake, mismatch)."""
        self.ticks += 1
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
        # prune after processing: with coalesced ticks, an early tick's Load
        # may target a frame below a later tick's confirmed frame
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
        if isinstance(stored, LazySlice):
            if self.pipeline and stored._stacked is self._last_stacked:
                # the load reads the output of the resim just dispatched:
                # the next resim is ordered after it on the stream, with no
                # host wait (counted, as the JAX runner counts the tick its
                # one-deep window degrades)
                self.pipeline_degrades += 1
            stored = tree_index(stored._stacked, stored._i)  # views, no copy
        self.world = self.app.reg.load_state(stored)
        self._world_checksum = checksum
        self.frame = frame
        # load_state returns a new world object, which only the runner holds
        self._world_donatable = True
        self._last_stacked = None

    # -- staging ----------------------------------------------------------------

    def _stage_rows(self, adv: List[AdvanceRequest]):
        """Fill the pinned input and status staging buffers and upload
        ``[k, ...]`` views of them: two copies, fenced by their events."""
        k = len(adv)
        row_in = np.asarray(adv[0].inputs)
        row_st = np.asarray(adv[0].status)
        stage = self._stage_inputs
        if (stage is None or self._stage_cap < k
                or stage.host.shape[1:] != row_in.shape
                or stage.host.dtype != row_in.dtype
                or self._stage_status.host.shape[1:] != row_st.shape
                or self._stage_status.host.dtype != row_st.dtype):
            cap = self._stage_cap = max(k, self._stage_cap * 2)
            dev = self.app.device
            self._stage_inputs = StagingBuffer(
                lambda: np.zeros((cap, *row_in.shape), row_in.dtype), dev)
            self._stage_status = StagingBuffer(
                lambda: np.zeros((cap, *row_st.shape), row_st.dtype), dev,
                self._stage_inputs.stream)
        ins = self._stage_inputs.acquire()
        sts = self._stage_status.acquire()
        san = staging.sanitizer()
        san.guard_write(ins, "runner._stage_rows/inputs")
        san.guard_write(sts, "runner._stage_rows/status")
        for i, a in enumerate(adv):
            ins[i] = a.inputs
            sts[i] = a.status
        return self._stage_inputs.commit(ins[:k]), self._stage_status.commit(sts[:k])

    def _stage_packed_rows(self, adv: List[AdvanceRequest], start_frame: int,
                           k_pad: Optional[int] = None, has_load: int = 0,
                           load_slot: int = 0) -> PackedUpload:
        """Pack a run's advances into the pinned single-upload buffer and
        upload its ``[k_pad + 1, W]`` view: the prefix row (frame, n_real,
        load words) and one payload row per frame.  A fixed-length
        (canonical) program passes ``k_pad > k``; padded rows repeat the
        last real row.  The prefix words travel on the host beside the
        upload."""
        spec = self.app.packed_spec
        k = len(adv)
        kp = k_pad if k_pad is not None else k
        if self.input_queue:
            if self._packed_queue is None or self._packed_cap < kp:
                cap = self._packed_cap = max(kp, self._packed_cap * 2)
                self._packed_queue = StagingQueue(lambda: spec.new_buffer(cap),
                                                  device=self.app.device)
            stage = self._packed_queue
        else:
            if self._stage_packed is None or self._packed_cap < kp:
                cap = self._packed_cap = max(kp, self._packed_cap * 2)
                self._stage_packed = StagingBuffer(lambda: spec.new_buffer(cap),
                                                   self.app.device)
            stage = self._stage_packed
        buf = stage.acquire()
        pack_prefix(buf, start_frame, k, has_load, load_slot)
        for i, a in enumerate(adv):
            pack_row(spec, buf, i, a.inputs, a.status)
        repeat_last_row(buf, k, kp)
        view = buf[:kp + 1]
        return PackedUpload(stage.commit(view), *prefix_words(view))

    def _note_dispatch_uploads(self, n: int, packed: Optional[PackedUpload] = None) -> None:
        """Upload census: ``n`` host-to-device copies rode this resim."""
        self.host_uploads += n
        if packed is not None:
            self.packed_upload_bytes += packed.nbytes

    # -- one resim per run --------------------------------------------------------

    def _run_batch(self, run: List[GgrsRequest]) -> None:
        """Serve a maximal Advance/Save run with one resim call."""
        app = self.app
        adv = [r for r in run if isinstance(r, AdvanceRequest)]
        k = len(adv)
        identity = app.reg.is_identity_strategy()
        pre_world, pre_checksum = self.world, self._world_checksum
        stacked = checks = None
        # Donation drops the runner's reference to the pre-resim world; a
        # leading (c == 0) save may still ring it, as no storage is reused
        donated_fn = app.packed_resim_fn_donated if self.packed else app.resim_fn_donated
        donate = (self.enable_donation and self._world_donatable and k > 0
                  and donated_fn is not None)
        if k:
            self.resims += 1
            self.rollback_frames += k - 1
            if self.packed:
                depth = app.canonical_depth
                if depth is not None and k > depth:
                    raise ValueError(
                        f"resim depth {k} exceeds canonical_depth {depth}; raise "
                        "App(canonical_depth=...) above every session window"
                    )
                packed = self._stage_packed_rows(adv, self.frame, k_pad=depth)
                fn = donated_fn if donate else app.packed_resim_fn
                final, stacked, checks = fn(self.world, packed)
                self._note_dispatch_uploads(1, packed)
            else:
                inputs, status = self._stage_rows(adv)
                fn = donated_fn if donate else app.resim_fn
                final, stacked, checks = fn(self.world, inputs, status, self.frame)
                self._note_dispatch_uploads(2)
            if donate:
                self.donated_dispatches += 1
            checks = BatchChecks(checks, self.readbacks)
            if self.pipeline:
                # the checksum copy rides behind the resim; the next update
                # harvests it while the card runs the next one
                self._rbq.start(checks)
            self.world = final
            self._world_donatable = True  # a resim's final world is fresh
            self._world_checksum = checks.ref(k - 1)
            self.frame = frame_add(self.frame, k)
        materialize_saves = False
        if stacked is not None:
            nbytes = self._stacked_bytes_by_k.get(k)
            if nbytes is None:
                nbytes = self._stacked_bytes_by_k[k] = tree_device_bytes(stacked)
            materialize_saves = nbytes > self.ring_materialize_bytes
            # a guarded run's saves are cloned out, so no ring entry pins
            # this output and no load can read it
            self._last_stacked = None if materialize_saves else stacked
        c = 0  # advances seen so far within the run
        for r in run:
            if isinstance(r, AdvanceRequest):
                c += 1
                continue
            if c == 0:
                state, cs_ref = pre_world, pre_checksum
            else:
                state, cs_ref = LazySlice(stacked, c - 1), checks.ref(c - 1)
                if materialize_saves:
                    state = state.materialize()
                    self.materialized_saves += 1
            stored = state if identity else app.reg.store_state(materialize(state))
            self.ring.push(r.frame, (stored, cs_ref))
            r.cell.save(r.frame, cs_ref)
