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
  instead of pinning whole stacks (counted in ``materialized_saves``).  As
  in the JAX runner, the decision rests on the resim's own stack: the
  cache-served saves of a partial hit follow it, and a full hit (no
  resim) keeps every save as a view of its cache entry.
- ``coalesce_frames=N``: an update that owes several frames flushes up to
  N ticks' requests through one request pass, so consecutive advances
  fuse into one resim.

- ``speculation=SpeculationConfig(...)`` (``ops/speculation.py``): every
  tick whose last advance ran on a predicted input hedges it with M
  candidate input rows in one branch-axis call (a draft), issued at the
  seam after the tick's requests; a rollback whose corrected inputs were
  hedged is served from that cache with zero resimulated frames (the hit
  path of :meth:`GgrsRunner._service_rollback`), bit for bit what a plain
  peer computes.  Under ``App(canonical_branches=B)`` every dispatch, a
  plain runner's too, is the one ``[B, K]`` program fed by one upload
  (``_dispatch_branched``), and the hedges ride its lanes.  A
  runner with a cache never donates (the drafts read the pre-advance
  world).  ``measure_rollback_service=True`` synchronizes the stream at
  the servicing seams and records each rollback's service time by path
  (hit, miss) for :meth:`GgrsRunner.stats`.

- ``megastep=True`` (``ops/megastep.py``): every Advance/Save run, and a
  rollback's load when its target is still in the device ring, is one
  fixed-shape ``k_max`` program fed by one packed upload; the host keeps a
  slot-to-frame mirror of the device ring, and a load whose target has left
  it restores from the host ring first (bit-identical: the device ring row
  is the same stacked row the host ring's lazy save points at).  It needs
  an identity snapshot strategy, excludes speculation and
  ``canonical_branches``, and turns donation off.  In eager torch it is
  slower than the default path in every case measured (a 1-frame flush
  runs ``k_max`` frames of launches: 3.3-3.6x the default's time per
  flush at ``stress_soa`` 1M on an H100, PERF.md): it is kept as the
  program a CUDA graph captures and for parity with the JAX runner's
  option, not as a faster mode.  Leave it off unless you capture it.

It serves SyncTest, P2P (Python and native core), spectator and replay
sessions.

Telemetry (``telemetry/``) rides the JAX runner's seams: a
:class:`~.telemetry.phases.PhaseSet` times each tick's phases into the
always-on flight recorder (and the ``tick_phase_ms`` histograms while
telemetry is on; :meth:`GgrsRunner.stats` ``["phases"]``); rollbacks are
attributed (``rollback_cause_total{handle}``, a flight entry each);
dispatch, stall and tick counters, the per-peer network families (a
:class:`~.telemetry.netstats.NetStatsSampler` attached by
:meth:`GgrsRunner.set_session`), device-memory rows for the ring, the
staging and the megastep ring, and a forensics report on a SyncTest
mismatch or a ``DesyncDetected`` when a forensics directory is set.  No
seam reads a tensor or adds a launch: the counts are host integers the
runner holds, and off costs one boolean check per seam.  The forensics
report is the exception, as in the JAX package: it reads the world's
per-component checksums after a detected desync.
"""

from __future__ import annotations

import dataclasses
import time
import weakref
from collections import Counter
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from . import telemetry
from .app import App
from .convert import to_numpy
from .ops.megastep import init_device_ring, make_megastep_fn
from .ops.packing import (
    PackedUpload,
    pack_prefix,
    pack_row,
    prefix_words,
    repeat_last_row,
    unpack_seq,
)
from .ops.resim import slice_frame
from .ops.speculation import SpeculationCache, SpeculationConfig
from .session.events import (
    DesyncDetected,
    InputStatus,
    InvalidRequestError,
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
from .telemetry import devmem
from .utils import compile_guard, staging
from .utils.frames import NULL_FRAME, frame_add
from .utils.mem import tree_device_bytes
from .utils.staging import StagingBuffer, StagingQueue
from .utils.tracing import span
from .utils.tree import tree_map

_REG = telemetry.registry()


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
        speculation: Optional[SpeculationConfig] = None,
        measure_rollback_service: bool = False,
        on_advance: Optional[Callable] = None,
        megastep: bool = False,
    ):
        self.app = app
        self.read_inputs = read_inputs or (
            lambda handles: {h: app.zero_inputs()[h] for h in handles}
        )
        self.on_event = on_event  # every session event, as it is drained
        # a mismatch goes to on_mismatch; with none set it raises
        self.on_mismatch = on_mismatch
        self.on_confirmed = on_confirmed  # (frame) after each request batch
        self.on_advance = on_advance  # (frame, inputs, status) per AdvanceFrame
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
        if (speculation is not None and app.canonical_depth is not None
                and app.canonical_branches is None):
            raise ValueError(
                "speculation under bit-determinism requires the canonical-"
                "branched program: set App(canonical_branches=M+1) so hedges "
                "run inside the same fixed [branches, depth] program every "
                "peer runs"
            )
        self.spec_cache = (
            SpeculationCache(app, speculation) if speculation is not None else None
        )
        # ordered cache-maintenance ops, ("inv", frame) invalidations and
        # ("spec", src_fn, ring_handle, start_frame, inputs) hedges, recorded
        # during request handling and applied in order by _flush_speculation
        self._pending_speculate: list = []
        self.cache_served_frames = 0  # rollback frames served from the cache
        # measurement mode: a stream synchronize at the servicing seams, and
        # each rollback's service time (ms) by path
        self.measure_rollback_service = bool(measure_rollback_service)
        self.rollback_service_ms: Dict[str, List[float]] = {"hit": [], "miss": []}
        # pinned [B, K + 1, W] staging of the canonical-branched dispatch
        self._stage_branched: Optional[StagingBuffer | StagingQueue] = None
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
        # Device-resident megastep (ops/megastep.py): a whole flush, with a
        # rollback's load when its target is still in the device ring, as
        # one program fed by one upload
        self.megastep = bool(megastep)
        if self.megastep:
            if not app.reg.is_identity_strategy():
                raise ValueError(
                    "megastep requires an identity snapshot strategy: the "
                    "device ring stores live stacked states, and a lossy "
                    "strategy's store/load round-trip would need to run "
                    "inside the ring select"
                )
            if speculation is not None:
                raise ValueError(
                    "megastep and speculation are mutually exclusive (the "
                    "megastep flush has no per-frame lookup seam)"
                )
            if app.canonical_branches is not None:
                raise ValueError(
                    "megastep is incompatible with canonical_branches "
                    "(the branched program owns its own dispatch shape)"
                )
            # the ring holds every recent state, so donation is never safe
            self.enable_donation = False
        self.megastep_dispatches = 0
        self.fused_ring_loads = 0  # rollbacks served from the device ring
        self._ms_fn = None
        self._ms_ring = None
        self._ms_ring_frames = None
        self._ms_k = 0  # megastep program depth (k_max)
        self._ms_slots = 0  # device ring depth R
        self._dev_frames: Dict[int, int] = {}  # slot -> resident frame
        # Telemetry (module docstring).  Pre-bound families: a per-tick
        # increment is one boolean check while telemetry is off.
        self._m_ticks = _REG.bind_counter("ticks_total", "session ticks stepped")
        self._m_dispatches = _REG.bind_counter("device_dispatches_total",
                                               "fused resim dispatches")
        self._m_resim_frames = _REG.bind_counter(
            "resim_frames_total", "frames resimulated beyond the first of each dispatch")
        self._m_donated = _REG.bind_counter("donated_dispatches_total",
                                            "dispatches donating the input world")
        self._m_uploads = _REG.bind_histogram(
            "uploads_per_dispatch",
            "host->device uploads issued per fused dispatch (1 on the packed path)",
            buckets=(1, 2, 3, 4, 8))
        self._m_packed_bytes = _REG.bind_counter(
            "packed_upload_bytes", "bytes staged through packed single-upload buffers")
        # tick-phase attribution, and the wall time of each program
        # variant's first dispatch (compile_ms; eager torch compiles
        # nothing, so it times the first call's allocations and setup)
        self._phases = telemetry.PhaseSet(owner="solo")
        self.compile_ms: Dict[str, float] = {}
        self._seen_variants: set = set()
        self._netstats = None  # per-peer sampler, attached by set_session
        # device-memory rows of this runner live under one tag and die with it
        self._devmem_tag = devmem.scope("solo")
        weakref.finalize(self, devmem.forget_scope, self._devmem_tag)
        self._world_nbytes = 0  # one world's bytes (set_session)
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
        """Replace the live world (a restore, a test's forced offset)."""
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
        # the megastep's program and device ring are sized from the
        # session's windows: rebuilt lazily at the next flush
        self._ms_fn = None
        self._ms_ring = None
        self._ms_ring_frames = None
        self._dev_frames = {}
        if self.spec_cache is not None:
            # the new session's frames restart: no branch of the old one may
            # serve them
            self.spec_cache.clear()
            self._pending_speculate = []
        self._netstats = (telemetry.NetStatsSampler(session)
                          if session is not None and hasattr(session, "network_stats")
                          else None)
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
        # ring residency = stored snapshots x one world's bytes (shapes are
        # static, so the unit is computed once per session)
        self._world_nbytes = tree_device_bytes(self._world)
        self.ring.set_accounting(self._devmem_tag + "/snapshot_ring", self._world_nbytes)
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
        """SyncTest mismatch: timeline event and forensics report (written
        only when a forensics directory is set), then ``on_mismatch`` (or
        the raise)."""
        telemetry.record("checksum_mismatch", source="synctest",
                         frames=list(e.mismatched_frames), current_frame=e.current_frame)
        telemetry.write_desync_report("synctest_mismatch", reg=self.app.reg,
                                      world=self.world, frames=e.mismatched_frames)
        if self.on_mismatch is None:
            raise e
        self.on_mismatch(e)

    def _report_desync(self, ev: DesyncDetected) -> None:
        """P2P ``DesyncDetected``: timeline event and forensics report.  The
        report carries every resolved local per-frame checksum the session
        still holds, so two peers' reports can be frame-aligned offline
        (:func:`~.telemetry.forensics.merge_reports`)."""
        telemetry.record("checksum_mismatch", source="p2p", frames=[ev.frame],
                         local_checksum=ev.local_checksum,
                         remote_checksum=ev.remote_checksum, addr=repr(ev.addr))
        if telemetry.forensics_dir() is None:
            return
        local = getattr(self.session, "_local_checksums", None) or {}
        telemetry.write_desync_report(
            "p2p_desync", reg=self.app.reg, world=self.world, frames=[ev.frame],
            local_checksum=ev.local_checksum, remote_checksum=ev.remote_checksum,
            addr=ev.addr, checksums={f: v for f, v in local.items() if isinstance(v, int)})

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
        ph = self._phases
        ph.begin_tick()
        if self.pipeline:
            # last tick's landed checksum copies, before the poll, so the
            # session publishes them this tick without waiting for the card
            with ph.phase("readback_harvest"):
                self._rbq.harvest()
        if hasattr(self.session, "poll_remote_clients"):
            with ph.phase("net_poll"):
                with span("PollRemoteClients"):
                    self.session.poll_remote_clients()
                self._drain_events()
                if self._netstats is not None:
                    self._netstats.poll()
                if _REG.enabled:
                    self._record_network_stats()
        pending: List[GgrsRequest] = []
        pending_ticks = 0
        ran_requests = False
        stepped = 0
        while self.accumulator >= fps_delta:
            self.accumulator -= fps_delta
            stepped += 1
            if hasattr(self.session, "frames_ahead"):
                self.run_slow = self.session.frames_ahead() > 0
            with ph.phase("session_step"):
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
            with ph.phase("readback_harvest"):
                self._drain_inflight()
        if stepped:
            # idle polls (sub-frame deltas, handshake spins) stay out of the
            # flight ring.  The residency and in-flight stamps feed the
            # trace's counter tracks, computed only while the tick records.
            if ph.on:
                ph.end_tick(frame=self.frame, device_bytes=devmem.total(),
                            pipeline_depth=self._rbq.depth() if self.pipeline else 0)
            else:
                ph.end_tick(frame=self.frame)

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

    def profile(self, logdir: str):
        """Context manager yielding the runner inside a ``torch.profiler``
        trace of its host activity and, on a card, the card's: the trace is
        written into ``logdir`` as a ``*.pt.trace.json`` (Chrome trace
        format; Perfetto or TensorBoard's profiler plugin read it).  The
        card's queue is drained before the trace closes."""
        import contextlib

        from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

        dev = self.app.device
        activities = [ProfilerActivity.CPU]
        if dev.type == "cuda":
            activities.append(ProfilerActivity.CUDA)

        @contextlib.contextmanager
        def cm():
            with profile(activities=activities,
                         on_trace_ready=tensorboard_trace_handler(str(logdir))):
                try:
                    yield self
                finally:
                    if dev.type == "cuda":
                        torch.cuda.synchronize(dev)

        return cm()

    def _staging(self) -> list:
        draft = self.spec_cache._stage if self.spec_cache is not None else None
        return [s for s in (self._stage_inputs, self._stage_status,
                            self._stage_packed, self._packed_queue,
                            self._stage_branched, draft) if s is not None]

    def stats(self) -> dict:
        """Runner health counters (rollback frequency and depth, resims,
        uploads, donation, the pipeline's degradations, staging waits, the
        speculation cache's hits and misses, and the rollback service
        times by path under ``measure_rollback_service``)."""
        spec = self.spec_cache
        service = {}
        for path, ms in self.rollback_service_ms.items():
            p50, p99 = np.percentile(ms, [50, 99]).tolist() if ms else (None, None)
            service[path] = {"n": len(ms), "p50": p50, "p99": p99}
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
            "megastep": self.megastep,
            "megastep_dispatches": self.megastep_dispatches,
            "fused_ring_loads": self.fused_ring_loads,
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
            "speculation_hits": spec.hits if spec else 0,
            "speculation_misses": spec.misses if spec else 0,
            "speculation_cached_bytes": spec.cached_bytes if spec else 0,
            "speculation_draft_dispatches": spec.draft_dispatches if spec else 0,
            "speculation_host_uploads": spec.host_uploads if spec else 0,
            "cache_served_frames": self.cache_served_frames,
            "rollback_service_ms": service,
            "phases": self._phases.totals(),
            "compile_ms": dict(self.compile_ms),
        }

    # -- per-session-type steps -----------------------------------------------

    def _step_session(self) -> Optional[List[GgrsRequest]]:
        """One session tick: its request list, or None if the tick produced
        nothing (stall, handshake, mismatch)."""
        self.ticks += 1
        self._m_ticks.inc()
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
            with span("SessionAdvanceFrame"):
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
            with span("SessionAdvanceFrame"):
                requests = s.advance_frame()
        except PredictionThresholdError:
            self.stalled_frames += 1
            if _REG.enabled:
                telemetry.count("stalled_frames_total", help="ticks skipped on stall",
                                kind="p2p")
                telemetry.record("stall", frame=self.frame, reason="prediction_threshold")
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
            if _REG.enabled:
                telemetry.count("stalled_frames_total", help="ticks skipped on stall",
                                kind="spectator")
                telemetry.record("stall", frame=self.frame, reason="waiting_for_host")
            return None
        except NotSynchronizedError:
            return None

    def _drain_events(self) -> None:
        """Move the session's pending events into :attr:`events` (a
        ``DesyncDetected`` among them also gets its timeline event and
        forensics report) and hand each to ``on_event``."""
        if not hasattr(self.session, "events"):
            return
        for ev in self.session.events():
            self.events.append(ev)
            if isinstance(ev, DesyncDetected):
                self._report_desync(ev)
            if self.on_event is not None:
                self.on_event(ev)

    def _record_network_stats(self) -> None:
        """Mirror per-peer NetworkStats into telemetry gauges plus one
        timeline event per peer (once per host tick while telemetry is
        on; host values only)."""
        s = self.session
        handles = getattr(s, "remote_handle_addr", None)
        if handles is None:
            if getattr(s, "is_spectator", False):
                behind = s.frames_behind_host()
                telemetry.gauge_set("spectator_frames_behind", behind,
                                    "spectator catchup lag")
                telemetry.record("network_stats", peer="host", frames_behind=behind)
            return
        for h in sorted(handles):
            try:
                st = s.network_stats(h)
            except InvalidRequestError:
                continue  # endpoint gone
            if not st.is_live:
                continue  # local / spectator / disconnected handle
            telemetry.gauge_set("ping_ms", st.ping_ms, "round-trip ping", peer=h)
            telemetry.gauge_set("send_queue_len", st.send_queue_len,
                                "pending outbound inputs", peer=h)
            telemetry.gauge_set("kbps_sent", st.kbps_sent, "outbound bandwidth", peer=h)
            telemetry.gauge_set("local_frames_behind", st.local_frames_behind,
                                "our frame lag vs this peer", peer=h)
            telemetry.gauge_set("remote_frames_behind", st.remote_frames_behind,
                                "peer's frame lag vs us", peer=h)
            telemetry.record("network_stats", peer=h, ping_ms=st.ping_ms,
                             send_queue_len=st.send_queue_len, kbps_sent=st.kbps_sent,
                             local_frames_behind=st.local_frames_behind,
                             remote_frames_behind=st.remote_frames_behind)
        if hasattr(s, "frames_ahead"):
            telemetry.observe("input_latency_frames", max(s.frames_ahead(), 0),
                              "frames the session runs ahead of confirmed remote input")

    # -- request dispatch -----------------------------------------------------

    def _handle_requests(self, requests: List[GgrsRequest]) -> None:
        with span("HandleRequests"):
            s = self.session
            self.ring.set_depth(self._ring_depth(s))
            self.confirmed = s.confirmed_frame()
            i, n = 0, len(requests)
            while i < n:
                load = requests[i] if isinstance(requests[i], LoadRequest) else None
                start = j = i + 1 if load is not None else i
                while j < n and isinstance(requests[j], (AdvanceRequest, SaveRequest)):
                    j += 1
                run = requests[start:j]
                if self.megastep:
                    # a load fuses into its run's dispatch when its target is
                    # still in the device ring
                    self._run_megastep(load, run)
                elif load is not None:
                    self._service_rollback(load, run)
                else:
                    self._run_batch(run)
                i = j
            # prune after processing: with coalesced ticks, an early tick's Load
            # may target a frame below a later tick's confirmed frame
            self.ring.confirm(self.confirmed)
            # fire after the batch: a corrective Load/Advance in the same list
            # must land before observers treat the frame as final
            if self.on_confirmed is not None and self.confirmed != NULL_FRAME:
                self.on_confirmed(self.confirmed)
            # drafts for the live frame ride the seam after the tick's requests,
            # once every rollback in them has been serviced (and timed)
            self._flush_speculation()

    # -- speculation seams ----------------------------------------------------

    def _flush_speculation(self) -> None:
        """Apply the cache-maintenance ops recorded during request handling,
        in recorded order: invalidations drop branches hedged from a
        superseded state, hedges issue their drafts.  Deferred here so a
        rollback's servicing does not carry next tick's drafts or last
        tick's frees; called before a Load's servicing (so a hedge recorded
        earlier in a coalesced list precedes the correction) and at the end
        of :meth:`_handle_requests`."""
        pending, self._pending_speculate = self._pending_speculate, []
        for op in pending:
            if op[0] == "inv":
                self.spec_cache.invalidate_after(op[1])
                continue
            _, src_fn, hit_handle, start, inputs = op
            if src_fn is None:
                # a depth-1 full hit: the pre-advance source is the rollback
                # target itself, the ring's stored form (views)
                src = self.app.reg.load_state(_stored_world(hit_handle))
            else:
                src = src_fn()
            self.spec_cache.speculate(src, start, inputs)
        if pending and self.measure_rollback_service:
            # measurement mode only: the drafts run in the slot that issued
            # them, so no later servicing span waits on them
            self.spec_cache.drain_drafts()

    def _sync_for_measurement(self) -> None:
        if self.app.device.type == "cuda":
            torch.cuda.current_stream(self.app.device).synchronize()

    def _service_rollback(self, load: LoadRequest, run: List[GgrsRequest]) -> None:
        """A LoadRequest plus its following Advance/Save run.

        The speculation cache is consulted first: a hit (the corrected input
        sequence was hedged) serves the rollback from cached branch states:
        the ring pop is bookkeeping only, the restored state and every
        resaved frame are views of the branch stack, and zero frames
        resimulate for the served prefix.  A miss (or no cache) is a ring
        load then one resim.  Under ``measure_rollback_service`` the stream
        is synchronized before and after, and the span recorded by path."""
        if self.spec_cache is not None:
            self._flush_speculation()
        if self.measure_rollback_service:
            self._sync_for_measurement()
        t0 = time.perf_counter()
        adv = [r for r in run if isinstance(r, AdvanceRequest)]
        got = None
        if self.spec_cache is not None and adv:
            got = self.spec_cache.lookup_seq(load.frame, np.stack([a.inputs for a in adv]))
            if _REG.enabled:
                telemetry.count("speculation_hits_total" if got is not None
                                else "speculation_misses_total",
                                help="speculative branch-cache lookups")
        if got is not None:
            self._note_rollback(load.frame, load.cause)
            with self._phases.phase("rollback_load"), span("LoadWorld"):
                # bookkeeping-only rollback: pop the ring entries above the
                # target and keep its stored handle; the world restore is
                # the cache select inside _run_batch
                stored, checksum = self.ring.rollback(load.frame)
                self.frame = load.frame
            self._pending_speculate.append(("inv", load.frame))
            self._last_stacked = None
            if _REG.enabled:
                telemetry.record("speculation_hit", frame=load.frame, depth=got[0],
                                 advances=len(adv))
            self._run_batch(run, hit=got, hit_pre=(stored, checksum))
        else:
            self._load(load.frame, load.cause)
            self._run_batch(run)
        path = "hit" if got is not None else "miss"
        if self.measure_rollback_service:
            self._sync_for_measurement()
            self.rollback_service_ms[path].append((time.perf_counter() - t0) * 1e3)
        if _REG.enabled:
            telemetry.observe(
                "rollback_service_ms", (time.perf_counter() - t0) * 1e3,
                "wall ms to service one rollback (LoadRequest + its following "
                "Advance/Save run)", buckets=telemetry.LATENCY_MS_BUCKETS, path=path)

    def _note_rollback(self, frame: int, cause=None) -> None:
        """Rollback attribution, shared by every load path: counts one
        rollback against the handle ``cause`` blames (``"unknown"`` when the
        session names none), so :attr:`rollbacks_by_cause` (always on) and
        ``rollback_cause_total{handle}`` (while telemetry is on) each sum to
        the rollbacks; the depth, the lateness and the always-on
        flight-recorder entry."""
        depth = self.frame - frame
        self.rollbacks += 1
        self._phases.note_rollback(depth)
        blamed = cause.handle if cause is not None else None
        if blamed is None:
            blamed = "unknown"
        self.rollbacks_by_cause[blamed] += 1
        fr = telemetry.flight_recorder()
        if not (_REG.enabled or fr.enabled):
            return
        lateness = cause.lateness if cause is not None else depth
        kind = cause.kind if cause is not None else "unknown"
        mismatch = bool(cause.mismatch) if cause is not None else False
        if _REG.enabled:
            telemetry.count("rollbacks_total", help="LoadRequests executed")
            telemetry.observe("rollback_depth", depth, "frames rolled back per LoadRequest")
            telemetry.count("rollback_cause_total",
                            help="rollbacks attributed to the peer whose input caused them",
                            handle=blamed)
            telemetry.observe("input_lateness_frames", lateness,
                              "frames late the blamed input arrived (rollback depth "
                              "it forced)", handle=blamed)
            telemetry.record("rollback", to_frame=frame, from_frame=self.frame,
                             depth=depth, handle=blamed, lateness=lateness,
                             mismatch=mismatch, cause_kind=kind)
        if fr.enabled:
            # the always-on ring gets the attributed entry too, so a desync
            # report names the blamed peer even when the registry was off
            fr.record("rollback", to_frame=frame, from_frame=self.frame,
                      depth=depth, handle=blamed, lateness=lateness,
                      mismatch=mismatch, cause_kind=kind)

    def _load(self, frame: int, cause=None) -> None:
        """LoadGameState: restore the ring snapshot for ``frame`` (the
        rollback counted by :meth:`_note_rollback`)."""
        self._note_rollback(frame, cause)
        with self._phases.phase("rollback_load"), span("LoadWorld"):
            stored, checksum = self.ring.rollback(frame)
            if isinstance(stored, LazySlice):
                if self.pipeline and stored._stacked is self._last_stacked:
                    # the load reads the output of the resim just
                    # dispatched: the next resim is ordered after it on the
                    # stream, with no host wait (counted, as the JAX runner
                    # counts the tick its one-deep window degrades)
                    self.pipeline_degrades += 1
                    if _REG.enabled:
                        telemetry.count(
                            "pipeline_degrade_total",
                            help="loads targeting the in-flight dispatch's output "
                                 "(pipeline degraded to synchronous for that tick)")
            self.world = self.app.reg.load_state(_stored_world(stored))
            self._world_checksum = checksum
            self.frame = frame
        # load_state returns a new world object, which only the runner holds
        self._world_donatable = True
        self._last_stacked = None
        if self.spec_cache is not None:
            # branches hedged from now-superseded predicted states must not
            # serve later lookups; the drop runs at the next seam
            self._pending_speculate.append(("inv", frame))

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
            devmem.note(self._devmem_tag + "/staging",
                        self._stage_inputs.nbytes + self._stage_status.nbytes)
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
                devmem.note(self._devmem_tag + "/packed_staging", self._packed_queue.nbytes)
            stage = self._packed_queue
        else:
            if self._stage_packed is None or self._packed_cap < kp:
                cap = self._packed_cap = max(kp, self._packed_cap * 2)
                self._stage_packed = StagingBuffer(lambda: spec.new_buffer(cap),
                                                   self.app.device)
                devmem.note(self._devmem_tag + "/packed_staging", self._stage_packed.nbytes)
            stage = self._stage_packed
        buf = stage.acquire()
        pack_prefix(buf, start_frame, k, has_load, load_slot)
        for i, a in enumerate(adv):
            pack_row(spec, buf, i, a.inputs, a.status)
        repeat_last_row(buf, k, kp)
        view = buf[:kp + 1]
        return PackedUpload(stage.commit(view), *prefix_words(view))

    def _note_dispatch_uploads(self, n: int, packed: Optional[PackedUpload] = None) -> None:
        """Upload census: ``n`` host-to-device copies rode this resim
        (always-on ints and the pre-bound families)."""
        self.host_uploads += n
        self._m_uploads.observe(n)
        if packed is not None:
            self.packed_upload_bytes += packed.nbytes
            self._m_packed_bytes.inc(packed.nbytes)

    def _note_compile(self, variant, dt: float) -> None:
        """Record a program variant's first-dispatch wall time: into
        :attr:`compile_ms`, the flight recorder and (telemetry on) the
        ``program_compile_ms`` histogram, as the JAX runner records its jit
        variants' first calls.  Eager torch compiles nothing, so this is
        the first call's host time (allocator growth, lazy kernel builds)."""
        kind, depth = variant
        self._seen_variants.add(variant)
        ms = dt * 1e3
        self.compile_ms[f"{kind}_k{depth}"] = round(ms, 3)
        telemetry.flight_recorder().record("compile", owner="solo", program=kind,
                                           k=depth, ms=round(ms, 3))
        telemetry.observe(
            "program_compile_ms", ms,
            "wall ms of each program variant's first dispatch (trace+compile)",
            buckets=telemetry.LATENCY_MS_BUCKETS, owner="solo", kind=kind)
        compile_guard.notify("solo", kind, ms)

    def arm_compile_guard(self) -> bool:
        """Declare warmup over: with ``BGT_COMPILE_GUARD=1`` (or
        :func:`~bevy_ggrs_tpu_torch.utils.compile_guard.set_compile_guard`)
        any later first dispatch of a program variant raises
        :class:`~bevy_ggrs_tpu_torch.utils.compile_guard.RecompileError`
        naming the owner/kind and bumps ``recompiles_steady_total{owner}``.
        Returns True when armed; no-op (False) when the guard is off."""
        return compile_guard.guard().arm()

    def _note_dispatch(self, n: int, skip: int, donated: bool, stacked_bytes: int,
                       megastep: bool = False) -> None:
        """The dispatch families and timeline event (telemetry on only)."""
        telemetry.gauge_set("save_bytes", stacked_bytes,
                            "device bytes of the last dispatch's stacked save buffer")
        fields = {"megastep": True} if megastep else {}
        telemetry.record("dispatch", frame=self.frame, advances=n, skipped=skip,
                         donated=donated, save_bytes=stacked_bytes, **fields)

    # -- one resim per run --------------------------------------------------------

    def _run_batch(self, run: List[GgrsRequest], hit=None, hit_pre=None) -> None:
        """Serve a maximal Advance/Save run with one resim call.

        ``hit``/``hit_pre`` come from :meth:`_service_rollback` when the
        rollback's corrected inputs were hedged: ``hit`` is the cache's
        ``lookup_seq`` result serving the first ``skip`` advances (a fully
        hedged rollback runs no resim at all) and ``hit_pre`` the ring's
        ``(stored, checksum)`` of the rollback target, for leading saves and
        a depth-1 re-hedge.  With a cache, the live frame's predicted
        advance is hedged for the next tick either way."""
        app = self.app
        adv = [r for r in run if isinstance(r, AdvanceRequest)]
        k = len(adv)
        ph = self._phases
        ph.note_advances(k)
        identity = app.reg.is_identity_strategy()
        pre_world, pre_checksum = self.world, self._world_checksum
        if self.on_advance is not None:
            # every AdvanceFrame of the run, in frame order, whichever path
            # serves it (resim, cache, branched program)
            for i, a in enumerate(adv):
                self.on_advance(frame_add(self.frame, i + 1), a.inputs, a.status)
        stacked = checks = None
        skip = 0
        cache_states = cache_bc = None
        hit_handle = hit_checksum = None
        if hit is not None:
            # served from the cache (_service_rollback popped the ring and
            # set the frame to the target): the world and its checksum are
            # views of the verified branch
            skip, cache_states, cache_checks = hit
            cache_bc = BatchChecks(cache_checks, self.readbacks)
            if self.pipeline:
                self._rbq.start(cache_bc)
            self.world = cache_states(skip - 1)
            self._world_checksum = cache_bc.ref(skip - 1)
            self.frame = frame_add(self.frame, skip)
            self.cache_served_frames += skip
            if _REG.enabled:
                telemetry.count("cache_served_frames_total", skip,
                                help="rollback frames served from the speculation cache "
                                     "instead of resimulated")
            hit_handle, hit_checksum = hit_pre
        # the state feeding the LAST advance (the next tick's hedge source),
        # as a thunk resolved at _flush_speculation.  After a full hit the
        # world is already post-advance: the source is the previous served
        # frame, or for one served advance the rollback target itself
        last_adv_src = (lambda w=self.world: w)
        if hit is not None and skip == k:
            last_adv_src = (lambda cs=cache_states, i=skip - 2: cs(i)) if skip >= 2 else None
        use_branched = app.canonical_branches is not None
        # Donation drops the runner's reference to the pre-resim world; a
        # leading (c == 0) save may still ring it, as no storage is reused.
        # Never with a cache: a hedge reads the pre-advance world later.
        donated_fn = app.packed_resim_fn_donated if self.packed else app.resim_fn_donated
        donate = (self.enable_donation and self.spec_cache is None
                  and self._world_donatable and k - skip > 0
                  and donated_fn is not None)
        full_stack = None  # what the run's saves pin: the whole branch stack
        if k - skip > 0:
            run_adv = adv[skip:]
            n = len(run_adv)
            self.resims += 1
            self.rollback_frames += n - 1
            self._m_dispatches.inc()
            self._m_resim_frames.inc(n - 1)
            variant = ("branched" if use_branched else
                       ("packed_" if self.packed else "") + ("donated" if donate else "plain"),
                       n)
            fresh = variant not in self._seen_variants
            with span("AdvanceWorld"):
                if use_branched:
                    t_build = time.perf_counter() if fresh else 0.0
                    final, stacked, checks, full_stack = self._dispatch_branched(run_adv)
                elif self.packed:
                    depth = app.canonical_depth
                    if depth is not None and n > depth:
                        raise ValueError(
                            f"resim depth {n} exceeds canonical_depth {depth}; raise "
                            "App(canonical_depth=...) above every session window"
                        )
                    with ph.phase("stage_inputs"):
                        packed = self._stage_packed_rows(run_adv, self.frame, k_pad=depth)
                    fn = donated_fn if donate else app.packed_resim_fn
                    args = (self.world, packed)
                else:
                    with ph.phase("stage_inputs"):
                        inputs, status = self._stage_rows(run_adv)
                    fn = donated_fn if donate else app.resim_fn
                    args = (self.world, inputs, status, self.frame)
                with ph.phase("wave_dispatch"):
                    if not use_branched:
                        t_build = time.perf_counter() if fresh else 0.0
                        final, stacked, checks = fn(*args)
                        if self.packed:
                            self._note_dispatch_uploads(1, packed)
                        else:
                            self._note_dispatch_uploads(2)
                    checks = BatchChecks(checks, self.readbacks)
                    if self.pipeline:
                        # the checksum copy rides behind the resim; the next
                        # update harvests it while the card runs the next one
                        self._rbq.start(checks)
            if fresh:
                self._note_compile(variant, time.perf_counter() - t_build)
            if donate:
                self.donated_dispatches += 1
                self._m_donated.inc()
            if self.spec_cache is not None and n >= 2:
                last_adv_src = (lambda s=stacked, i=n - 2: slice_frame(s, i))
            self.world = final
            self._world_donatable = True  # a resim's final world is fresh
            self._world_checksum = checks.ref(n - 1)
            self.frame = frame_add(self.frame, n)
        materialize_saves = False
        if stacked is not None:
            key = (use_branched, k - skip)
            nbytes = self._stacked_bytes_by_k.get(key)
            if nbytes is None:
                nbytes = self._stacked_bytes_by_k[key] = tree_device_bytes(
                    stacked if full_stack is None else full_stack)
            materialize_saves = nbytes > self.ring_materialize_bytes
            # a guarded run's saves are cloned out, so no ring entry pins
            # this output and no load can read it
            self._last_stacked = None if materialize_saves else stacked
            if _REG.enabled:
                self._note_dispatch(k - skip, skip, donate, nbytes)
        with ph.phase("store_save"), span("SaveWorld"):
            c = 0  # advances seen so far within the run
            for r in run:
                if isinstance(r, AdvanceRequest):
                    c += 1
                    continue
                if c == 0:
                    if hit is not None:
                        # a leading save after a cache-served rollback: the
                        # ring pop handed over the target's stored form;
                        # push it back
                        self.ring.push(r.frame, (hit_handle, hit_checksum))
                        r.cell.save(r.frame, hit_checksum)
                        continue
                    state, cs_ref = pre_world, pre_checksum
                elif c <= skip:
                    # a cache-served frame: a view of the branch stack,
                    # cloned only where the run's own resim stack passes
                    # the guard
                    state, cs_ref = (LazySlice(cache_states.stacked, c - 1),
                                     cache_bc.ref(c - 1))
                    if materialize_saves:
                        state = state.materialize()
                        self.materialized_saves += 1
                else:
                    state, cs_ref = LazySlice(stacked, c - 1 - skip), checks.ref(c - 1 - skip)
                    if materialize_saves:
                        state = state.materialize()
                        self.materialized_saves += 1
                stored = state if identity else app.reg.store_state(materialize(state))
                self.ring.push(r.frame, (stored, cs_ref))
                r.cell.save(r.frame, cs_ref)
        # hedge the live frame: if its inputs were (partly) predicted, fan
        # out candidate branches for the same transition at the next seam
        # (the branched program hedged inside its own dispatch)
        if (self.spec_cache is not None and not use_branched and k > 0
                and np.any(adv[-1].status == InputStatus.PREDICTED)):
            self._pending_speculate.append(
                ("spec", last_adv_src, hit_handle, frame_add(self.frame, -1),
                 adv[-1].inputs))

    def _dispatch_branched(self, adv: List[AdvanceRequest]):
        """One canonical ``[B, K]`` dispatch: lane 0 runs the real inputs;
        when the last advance was predicted, hedge lanes replay the real
        prefix and then hold a candidate input from the last transition on,
        and their frames fill the cache (the entries come out of the same
        program every peer runs).  The lanes' rows ride one pinned
        ``int8[B, K + 1, W]`` upload.  Returns lane 0's ``(final, stacked,
        checks)`` trimmed to the run, and the whole branch stack."""
        app = self.app
        lanes, depth = app.canonical_branches, app.canonical_depth
        spec = app.packed_spec
        k = len(adv)
        if k > depth:
            raise ValueError(f"resim depth {k} exceeds canonical_depth {depth}")
        cands = None
        if self.spec_cache is not None and np.any(adv[-1].status == InputStatus.PREDICTED):
            cands = np.asarray(self.spec_cache.config.candidates_fn(adv[-1].inputs),
                               app.input_dtype)[:lanes - 1]
        ph = self._phases
        with ph.phase("stage_inputs"):
            if self._stage_branched is None:
                # pipelined: two buffers in turn, so a dispatch never waits
                # on the previous one's upload
                make = lambda: spec.new_batch_buffer(lanes, depth)  # noqa: E731
                self._stage_branched = (StagingQueue(make, device=app.device)
                                        if self.pipeline else StagingBuffer(make, app.device))
            buf = self._stage_branched.acquire()
            pack_prefix(buf[0], self.frame, k)
            for i, a in enumerate(adv):
                pack_row(spec, buf[0], i, a.inputs, a.status)
            repeat_last_row(buf[0], k, depth)
            buf[1:] = buf[0]
            n_real = [k] * lanes
            m = 0 if cands is None else cands.shape[0]
            zero_status = np.zeros(app.num_players, np.int8)
            for b in range(1, 1 + m):
                pack_prefix(buf[b], self.frame, depth)
                pack_row(spec, buf[b], k - 1, cands[b - 1], zero_status)
                repeat_last_row(buf[b], k, depth)  # hedges hold the candidate
                n_real[b] = depth
        with ph.phase("wave_dispatch"):
            rows = self._stage_branched.commit(buf)
            self._note_dispatch_uploads(1, PackedUpload(rows, self.frame, k))
            inputs_b, status_b = unpack_seq(spec, rows)
            finals, stacked, checks = app.branched_fn(self.world, inputs_b, status_b,
                                                      self.frame, n_real)
            if m:
                self.spec_cache.fill_from_branched(
                    frame_add(self.frame, k - 1), cands,
                    tree_map(lambda a: a[1:1 + m], stacked), checks[1:1 + m],
                    offset=k - 1, depth_eff=depth - (k - 1))
        return (tree_map(lambda a: a[0], finals), tree_map(lambda a: a[0, :k], stacked),
                checks[0, :k], stacked)

    # -- the device-resident megastep (ops/megastep.py) ----------------------------

    def _ensure_megastep(self) -> None:
        """Build the megastep program and device ring for the current
        session on first use: one fixed ``k_max`` per session, so every
        flush runs the same launches."""
        if self._ms_fn is not None:
            return
        s = self.session
        # the deepest session-shaped run: a rollback in the same coalesced
        # flush as catch-up ticks
        self._ms_k = self.coalesce_frames + max(self._rollback_window(s),
                                                s.max_prediction())
        # one slot more than the host ring, so k_max < R: no two real rows
        # of one call share a slot
        self._ms_slots = self._ring_depth(s) + 1
        app = self.app
        self._ms_fn = make_megastep_fn(
            app.reg, app.step, app.packed_spec, app.fps, seed=app.seed,
            retention=app.retention, k_max=self._ms_k, ring_slots=self._ms_slots)
        self._ms_ring, self._ms_ring_frames = init_device_ring(self.world, self._ms_slots)
        self._dev_frames = {}
        # the device ring is a fixed [slots, ...] stacked world plus its
        # slot -> frame vector
        devmem.note(self._devmem_tag + "/megastep_ring",
                    tree_device_bytes(self._ms_ring) + tree_device_bytes(self._ms_ring_frames))

    def _dev_slot(self, frame: int) -> Optional[int]:
        """The device-ring slot holding ``frame``, or None when it was
        overwritten or never written (the host mirror makes the check
        exact: a miss restores from the host ring, never a wrong row).
        Python's ``%`` is non-negative, as ``torch.remainder`` by a
        positive divisor is on the card, so wrapped frames agree."""
        slot = frame % self._ms_slots
        return slot if self._dev_frames.get(slot) == frame else None

    def _run_megastep(self, load: Optional[LoadRequest], run: List[GgrsRequest]) -> None:
        """A megastep flush: an optional load plus its following
        Advance/Save run, as one dispatch fed by one upload per ``k_max``
        advances, the load inside it when its target is in the device
        ring."""
        self._ensure_megastep()
        n_adv = sum(1 for r in run if isinstance(r, AdvanceRequest))
        has_load = load_slot = 0
        loaded_pair = None
        if load is not None:
            slot = self._dev_slot(load.frame) if n_adv > 0 else None
            if slot is None:
                # a ring miss (or nothing to replay): the host ring restores
                self._load(load.frame, load.cause)
            else:
                # bookkeeping only: the state is selected on the device
                self._note_rollback(load.frame, load.cause)
                with self._phases.phase("rollback_load"), span("LoadWorld"):
                    loaded_pair = self.ring.rollback(load.frame)
                    self._world_checksum = loaded_pair[1]
                    self.frame = load.frame
                self.fused_ring_loads += 1
                if _REG.enabled:
                    telemetry.count("fused_ring_loads_total",
                                    help="rollback loads served from the device ring "
                                         "inside the megastep dispatch")
                has_load, load_slot = 1, slot
                self._last_stacked = None
        # chunk at k_max advances: session runs always fit, replayed or
        # scripted request lists may not
        i, n = 0, len(run)
        while i < n:
            j, c = i, 0
            while j < n:
                if isinstance(run[j], AdvanceRequest):
                    if c == self._ms_k:
                        break
                    c += 1
                j += 1
            self._megastep_chunk(run[i:j], has_load, load_slot, loaded_pair)
            has_load, load_slot, loaded_pair = 0, 0, None
            i = j

    def _megastep_chunk(self, run: List[GgrsRequest], has_load: int, load_slot: int,
                        loaded_pair) -> None:
        """One megastep dispatch: at most ``k_max`` advances and their
        saves, consuming a fused device-ring load when one is given."""
        adv = [r for r in run if isinstance(r, AdvanceRequest)]
        k = len(adv)
        ph = self._phases
        ph.note_advances(k)
        pre_world, pre_checksum = self.world, self._world_checksum
        if self.on_advance is not None:
            for i, a in enumerate(adv):
                self.on_advance(frame_add(self.frame, i + 1), a.inputs, a.status)
        stacked = checks = None
        if k > 0:
            self.resims += 1
            self.megastep_dispatches += 1
            self.rollback_frames += k - 1
            self._m_dispatches.inc()
            self._m_resim_frames.inc(k - 1)
            variant = ("megastep", self._ms_k)
            fresh = variant not in self._seen_variants
            with span("AdvanceWorld"):
                with ph.phase("stage_inputs"):
                    packed = self._stage_packed_rows(adv, self.frame, k_pad=self._ms_k,
                                                     has_load=has_load, load_slot=load_slot)
                t_build = time.perf_counter() if fresh else 0.0
                with ph.phase("wave_dispatch"):
                    final, self._ms_ring, self._ms_ring_frames, stacked, checks = self._ms_fn(
                        self.world, self._ms_ring, self._ms_ring_frames, packed.rows)
                    self._note_dispatch_uploads(1, packed)
                    checks = BatchChecks(checks, self.readbacks)
                    if self.pipeline:
                        self._rbq.start(checks)
            if fresh:
                self._note_compile(variant, time.perf_counter() - t_build)
            # the host mirror of the device writeback (slot -> frame).  Across
            # the i32 wrap two frames of one call can share a slot, and which
            # row the device keeps is then unspecified: such a slot is
            # forgotten, so a load of either frame restores from the host ring
            written = [frame_add(self.frame, i + 1) for i in range(k)]
            slots = [f % self._ms_slots for f in written]
            for f, slot in zip(written, slots):
                if slots.count(slot) == 1:
                    self._dev_frames[slot] = f
                else:
                    self._dev_frames.pop(slot, None)
            self.world = final
            self._world_checksum = checks.ref(k - 1)
            self.frame = frame_add(self.frame, k)
        materialize_saves = False
        if stacked is not None:
            key = ("megastep", self._ms_k)
            nbytes = self._stacked_bytes_by_k.get(key)
            if nbytes is None:
                nbytes = self._stacked_bytes_by_k[key] = tree_device_bytes(stacked)
            materialize_saves = nbytes > self.ring_materialize_bytes
            self._last_stacked = None if materialize_saves else stacked
            if _REG.enabled:
                self._note_dispatch(k, 0, False, nbytes, megastep=True)
        with ph.phase("store_save"), span("SaveWorld"):
            c = 0  # advances seen so far within the run
            for r in run:
                if isinstance(r, AdvanceRequest):
                    c += 1
                    continue
                if c == 0:
                    # a leading save after a fused load re-pushes the
                    # rollback's own handle: the live world was selected on
                    # the device
                    state, cs_ref = loaded_pair if loaded_pair is not None else (
                        pre_world, pre_checksum)
                else:
                    # identity strategies only: the stacked row is the
                    # stored form
                    state, cs_ref = LazySlice(stacked, c - 1), checks.ref(c - 1)
                    if materialize_saves:
                        state = state.materialize()
                        self.materialized_saves += 1
                self.ring.push(r.frame, (state, cs_ref))
                r.cell.save(r.frame, cs_ref)


def _stored_world(stored):
    """A ring entry's stored world: a lazy save's frame as views of its
    stack (no copy), anything else as it is."""
    if isinstance(stored, LazySlice):
        return tree_index(stored._stacked, stored._i)
    return stored
