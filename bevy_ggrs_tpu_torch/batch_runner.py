"""BatchedRunner — the many-worlds game server.

Port of ``bevy_ggrs_tpu/batch_runner.py`` (single device).  One card eats
hundreds of small worlds per pass, and a lobby's tick is bound by host
launches, so M serial dispatches are the one thing the server must not
do.  This runner owns M sessions (SyncTest and P2P alike: anything that
speaks the request protocol) over ONE resident ``[M, ...]`` stacked world.
Each server tick it:

1. polls every session and collects its request list (host side);
2. splits each lobby's list into an ordered sequence of ops,
   ``Load(frame)`` / ``Run([Save|Advance ...])``, the segments the solo
   runner fuses (:func:`_split_ops`);
3. executes the ops positionally as WAVES across lobbies: wave w batches
   every lobby's w-th Run into ONE call through the
   :class:`~.ops.batch.BucketedWaveExecutor` (one packed upload from
   pinned staging; each lane's clock read from its prefix on the card;
   one checksum fold launch over the wave's ``[M·k, N]`` stack), and
   serves Load ops from the per-lobby snapshot rings with one gather per
   source buffer (``snapshot/lazy.plan_row_gather`` and
   ``fused_load_rows``), whose indices ride one upload.

So a steady tick launches the same work whatever M is: the launches per
tick are flat in the lobby count (``chip_smoke.py`` phase ``batched``
counts them at M=4 and M=16).  Saves store ``LazySlice(stacked, (lobby,
frame))`` handles into the wave's stack, and each wave's checksums are
one :class:`~.snapshot.lazy.BatchChecks` whose copy to the host starts at
dispatch and is harvested at the next tick (``pipeline=True``), through
the port's :class:`~.snapshot.lazy.ReadbackQueue`.  Nothing is written in
place: a load replaces the resident world's rows out of place, because a
ring entry may share its tensors.

Speculation (``speculation=SpeculationConfig(...)``): each tick, one extra
packed wave fills only the lanes the last run wave left idle with draft
branches of the lobbies whose last advance was predicted
(:class:`~.ops.batch.DraftWaveScheduler`); a Load whose following run was
fully hedged is served from the lobby's branch cache (zero resimulated
frames).  Drafts ride the packed staging and scatter cached states straight
into the resident world, so speculation needs ``packed=True`` and an
identity snapshot strategy (ValueError otherwise, as in the JAX package).

Bit equality: eager torch runs the same kernels on every lane, so a lane
is bit-equal to a solo runner's resim of the same inputs (the JAX
package's caveat, that the vmapped program is a different XLA program, does
not arise; ``ops/variant_probe.py`` checks an app).  Canonical modes are
refused with the JAX package's error.

Telemetry rides the JAX server's seams: a ``batched``
:class:`~.telemetry.phases.PhaseSet` (flight entries stamped with the
lobby count), pre-bound dispatch and tick families, per-lobby ``lobby``
labels on the rollback, stall and mismatch families, devmem rows for the
resident worlds, each lobby's ring and the staging, and a per-lobby
forensics report on a desync or SyncTest mismatch when a forensics
directory is set.  No seam reads a tensor but that report.

Lobbies across devices (``mesh=parallel.make_lobby_mesh(...)`` with more
than one shard): the resident world is padded to a multiple of the shard
count and held as a :class:`~.snapshot.lazy.LobbyShards`, one contiguous
block of lobby lanes per shard on its device; every wave goes through the
:class:`~.ops.batch.ShardedWaveExecutor` (one call per shard, no
collectives), a :class:`ShardPlanner` publishes each wave's
``shard_imbalance_ratio``, and ``stats()["sharded"]`` reports the layout.
Lobby ``b`` lives on shard ``b // lanes`` at row ``b % lanes``; loads,
saves and checksum refs map it there.  A one-shard mesh keeps the plain
executor (the JAX package's fallback), and speculation with a mesh is
refused with the JAX error.  The counters are plain attributes and
:meth:`stats`.
"""

from __future__ import annotations

import dataclasses
import time
import weakref
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from . import telemetry
from .app import App
from .ops.batch import (
    BucketedWaveExecutor,
    DraftWaveScheduler,
    ShardedWaveExecutor,
    stack_worlds,
)
from .ops.packing import pack_prefix, pack_row, repeat_last_row
from .ops.speculation import SpeculationCache, SpeculationConfig
from .session.events import (
    DesyncDetected,
    InputStatus,
    MismatchedChecksumError,
    NotSynchronizedError,
    PredictionThresholdError,
    SessionState,
)
from .session.requests import AdvanceRequest, GgrsRequest, LoadRequest, SaveRequest
from .session.synctest import SyncTestSession
from .snapshot.checksum import world_checksums
from .snapshot.lazy import (
    BatchChecks,
    LazySlice,
    LobbyShards,
    ReadbackStats,
    RowIndexStager,
    fused_gather_rows,
    fused_load_rows,
    materialize,
    plan_row_gather,
    readback_queue,
    tree_index,
)
from .snapshot.ring import SnapshotRing, rollback_many
from .telemetry import devmem
from .utils import compile_guard
from .utils.frames import NULL_FRAME, frame_add
from .utils.mem import tree_device_bytes, tree_storage_bytes
from .utils.tracing import span
from .utils.tree import tree_map

_REG = telemetry.registry()


class _Op:
    __slots__ = ("load_frame", "load_cause", "run")

    def __init__(self, load_frame=None, run=None, load_cause=None):
        self.load_frame = load_frame  # int | None
        self.load_cause = load_cause  # RollbackCause | None
        self.run = run  # List[GgrsRequest] | None


def _split_ops(requests: List[GgrsRequest]) -> List[_Op]:
    """``[Load?](Advance|Save)*`` request list -> ordered Load/Run ops (the
    solo runner's maximal-run fusion)."""
    ops: List[_Op] = []
    i, n = 0, len(requests)
    while i < n:
        r = requests[i]
        if isinstance(r, LoadRequest):
            ops.append(_Op(load_frame=r.frame, load_cause=r.cause))
            i += 1
        else:
            j = i
            while j < n and isinstance(requests[j], (AdvanceRequest, SaveRequest)):
                j += 1
            ops.append(_Op(run=requests[i:j]))
            i = j
    return ops


def _set_row(tree, b: int, row):
    """``tree`` with lobby ``b``'s row replaced by ``row``, out of place
    (one ``cat`` per leaf, no index upload); on a :class:`LobbyShards`,
    in lobby ``b``'s shard."""
    if isinstance(tree, LobbyShards):
        d, r = tree.locate(b)
        parts = list(tree.parts)
        dev = tree.devices[d]
        parts[d] = _set_row(parts[d], r, tree_map(lambda x: x.to(dev), row))
        return LobbyShards(parts, tree.lanes)
    return tree_map(lambda a, x: torch.cat((a[:b], x.unsqueeze(0), a[b + 1:])), tree, row)


def _world_bytes(worlds) -> int:
    if isinstance(worlds, LobbyShards):
        return sum(tree_device_bytes(p) for p in worlds.parts)
    return tree_device_bytes(worlds)


class ShardPlanner:
    """Host-side shard accounting for the lobby-sharded executor (the JAX
    class, arithmetic for arithmetic).

    Lobby lanes map to shards statically: lobby ``b`` lives on shard
    ``b // (m_pad / D)`` (contiguous blocks), so the decision the planner
    owns is the per-wave shape: it derives each shard's active-lane count
    and hottest advance depth from the wave's ``ks``, publishes the
    ``shard_imbalance_ratio`` gauge (max/mean active lobbies per shard;
    1.0 is a flat wave), and tracks the worst ratio seen.  A ratio that
    stays high is the signal to re-home lobbies across shards."""

    def __init__(self, n_lobbies: int, n_devices: int):
        self.n_lobbies = int(n_lobbies)
        self.n_devices = int(n_devices)
        self.m_pad = -(-self.n_lobbies // self.n_devices) * self.n_devices
        self.lanes_per_shard = self.m_pad // self.n_devices
        self.last_imbalance = 1.0
        self.max_imbalance = 1.0
        self.waves_planned = 0
        self._g_imbalance = telemetry.registry().bind_gauge(
            "shard_imbalance_ratio",
            "max/mean active lobbies per device for the tick's run wave")

    def shard_of(self, b: int) -> int:
        """Shard index owning lobby lane ``b``."""
        return b // self.lanes_per_shard

    def plan(self, ks: Sequence[int]) -> dict:
        """One wave's per-lobby advance counts as per-shard buckets:
        ``{"active_per_shard", "k_hot_per_shard", "imbalance_ratio"}``;
        publishes the gauge."""
        active = [0] * self.n_devices
        hot = [0] * self.n_devices
        for b, k in enumerate(ks):
            if k > 0:
                d = self.shard_of(b)
                active[d] += 1
                hot[d] = max(hot[d], k)
        total = sum(active)
        ratio = (max(active) * self.n_devices / total) if total else 1.0
        self.last_imbalance = ratio
        self.max_imbalance = max(self.max_imbalance, ratio)
        self.waves_planned += 1
        self._g_imbalance.set(ratio)
        return {"active_per_shard": active, "k_hot_per_shard": hot,
                "imbalance_ratio": ratio}


class BatchedRunner:
    """M lobbies, one call per wave (see module docstring).  Runs on the
    app's device: CUDA unless the app was built with ``device="cpu"``.
    ``mesh`` (a ``parallel.make_lobby_mesh`` handle) shards the lobby axis
    when it has more than one shard."""

    def __init__(
        self,
        app: App,
        sessions: Sequence,
        read_inputs: Optional[Callable[[int, List[int]], Dict[int, np.ndarray]]] = None,
        on_mismatch: Optional[Callable[[int, MismatchedChecksumError], None]] = None,
        on_event: Optional[Callable[[int, object], None]] = None,
        k_max: Optional[int] = None,
        pipeline: bool = True,
        packed: bool = True,
        mesh=None,
        speculation: Optional[SpeculationConfig] = None,
    ):
        if app.canonical_depth is not None or app.canonical_branches is not None:
            raise ValueError("BatchedRunner is incompatible with canonical mode "
                             "(see ops/batch.make_batched_resim_fn)")
        self.app = app
        self.sessions = list(sessions)
        m = len(self.sessions)
        if m == 0:
            raise ValueError("BatchedRunner needs at least one session")
        # the deepest run a session can emit in one tick: a rollback spans
        # the full window plus the live advance
        windows = []
        for s in self.sessions:
            w = s.rollback_window() if hasattr(s, "rollback_window") else s.max_prediction()
            windows.append(max(w, s.max_prediction()))
            if app.retention < w:
                raise ValueError(
                    f"App(retention={app.retention}) < session rollback window ({w}) "
                    "— see GgrsRunner.set_session")
            if hasattr(s, "bind_device"):
                s.bind_device(app.device)
        self.k_max = k_max if k_max is not None else max(windows) + 1
        self.read_inputs = read_inputs or (
            lambda lobby, handles: {h: app.zero_inputs()[h] for h in handles})
        self.on_mismatch = on_mismatch
        self.on_event = on_event
        self.events: List = []  # (lobby, event) of every drained session event
        self._np = self.sessions[0].num_players()
        for s in self.sessions:
            if s.num_players() != self._np:
                raise ValueError("all lobbies must share num_players "
                                 "(one batched input tensor)")
        # lobby-mesh sharding engages only when the mesh has more than one
        # shard (a one-card host's default mesh keeps the plain executor)
        if mesh is not None and not hasattr(mesh, "shard_names"):
            raise ValueError(f"mesh must be a lobby mesh (parallel.make_lobby_mesh), "
                             f"not {type(mesh).__name__}")
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        self.planner: Optional[ShardPlanner] = None
        if self.mesh is not None:
            self.planner = ShardPlanner(m, self.mesh.size)
        m_pad = self._m_pad = self.planner.m_pad if self.planner is not None else m
        # the resident world: padded to a shard-count multiple in sharded
        # mode (pad lanes stay idle: every wave masks them at n_real=0) and
        # held as one block of lanes per shard
        self.worlds = stack_worlds([app.init_state() for _ in range(m_pad)])
        if self.mesh is not None:
            from .parallel.mesh import shard_lobby_worlds

            self.worlds = shard_lobby_worlds(self.mesh, self.worlds)
            self.exec = ShardedWaveExecutor(app, self.k_max, self.mesh)
            init_checks = self.worlds.map(lambda w: world_checksums(app.reg, w))
        else:
            self.exec = BucketedWaveExecutor(app, self.k_max)
            init_checks = world_checksums(app.reg, self.worlds)
        self._rows = RowIndexStager(app.device)
        self.readbacks = ReadbackStats()
        self.pipeline = bool(pipeline)
        self._rbq = readback_queue()
        init_batch = BatchChecks(init_checks, self.readbacks)
        if self.pipeline:
            self._rbq.start(init_batch)
        self._world_checksum = [init_batch.ref(b) for b in range(m)]
        # device-memory rows: the resident stacked world, each lobby's ring
        # (one world row per stored entry) and the staging, under this
        # instance's tag
        self._devmem_tag = devmem.scope("batched")
        weakref.finalize(self, devmem.forget_scope, self._devmem_tag)
        worlds_nbytes = _world_bytes(self.worlds)
        devmem.note(self._devmem_tag + "/worlds", worlds_nbytes)
        self.rings = [SnapshotRing(depth=max(windows) + 2) for _ in range(m)]
        for b, ring in enumerate(self.rings):
            ring.set_accounting(f"{self._devmem_tag}/ring{b}", worlds_nbytes // m_pad)
        self.frames = [0] * m  # per-lobby RollbackFrameCount
        self.confirmed = [NULL_FRAME] * m
        self.ticks = 0
        self.rollbacks = 0
        self.device_dispatches = 0
        self.fused_loads = 0
        self.fallback_loads = 0
        self.stalled = [0] * m
        # persistent host staging, filled in place every wave; idle lanes
        # keep stale rows (the masked program discards them, the exact one
        # never sees them).  The executor copies a wave's slice into pinned
        # staging of its own and uploads it once.
        self._stage_inputs = np.zeros((m_pad, self.k_max, self._np, *app.input_shape),
                                      app.input_dtype)
        self._stage_status = np.zeros((m_pad, self.k_max, self._np), np.int8)
        self._stage_starts = np.zeros((m_pad,), np.int32)
        self.packed = bool(packed)
        self._stage_packed = (app.packed_spec.new_batch_buffer(m_pad, self.k_max)
                              if self.packed else None)
        devmem.note(self._devmem_tag + "/staging",
                    self._stage_inputs.nbytes + self._stage_status.nbytes
                    + self._stage_starts.nbytes)
        if self._stage_packed is not None:
            devmem.note(self._devmem_tag + "/packed_staging", self._stage_packed.nbytes)
        # speculative draft waves (module docstring)
        self.spec_caches: Optional[List[SpeculationCache]] = None
        self.spec_config = speculation
        self.draft_waves = 0
        self.cache_served_frames = 0
        self._last_wave = None  # (prev_worlds, stacked, ks) of the last run wave
        self._last_adv: Optional[List[list]] = None
        self._draft_sched: Optional[DraftWaveScheduler] = None
        if speculation is not None:
            if not self.packed:
                raise ValueError("BatchedRunner speculation requires packed=True: draft "
                                 "waves ride the packed single-upload batch staging")
            if not app.reg.is_identity_strategy():
                raise ValueError("BatchedRunner speculation requires an identity snapshot "
                                 "strategy: cached branch states scatter straight into "
                                 "the resident stacked world on a hit")
            if self.mesh is not None:
                raise ValueError("BatchedRunner speculation is not shard-aware yet: the "
                                 "draft wave's base gather and hit scatter assume a "
                                 "single-device resident world")
            depth = max(speculation.depth, 1)
            if depth > self.k_max:
                raise ValueError(f"speculation depth {depth} exceeds k_max={self.k_max}; "
                                 "drafts dispatch through the same bucketed wave "
                                 "executor as real runs")
            self.spec_caches = [SpeculationCache(app, speculation) for _ in range(m)]
            self._draft_sched = DraftWaveScheduler(m)
            self._draft_bucket = self.exec.bucket_for(depth)
            self._stage_packed_draft = app.packed_spec.new_batch_buffer(m, self._draft_bucket)
            devmem.note(self._devmem_tag + "/draft_staging", self._stage_packed_draft.nbytes)
            self._m_drafts = _REG.bind_counter(
                "draft_dispatches_total",
                "speculative draft dispatches issued into idle pipeline slots "
                "/ spare wave lanes")
        identity = app.reg.is_identity_strategy()
        self._load_transform = None if identity else app.reg.load_state
        self._store_transform = None if identity else app.reg.store_state
        self._phases = telemetry.PhaseSet(owner="batched")
        self._m_ticks = _REG.bind_counter("server_ticks_total",
                                          "batched-server ticks (all lobbies)")
        self._m_dispatches = _REG.bind_counter(
            "device_dispatches_total", "fused device dispatches (resim + load + store waves)")
        self._m_resim_frames = _REG.bind_counter(
            "resim_frames_total", "frames resimulated beyond the first of each dispatch")
        self._m_fused_loads = _REG.bind_counter(
            "fused_load_dispatches_total", "load waves served by one mixed-source gather")
        self._m_fallback_loads = _REG.bind_counter(
            "fallback_load_rows_total",
            "load rows served by per-lobby scatter (non-LazySlice snapshot)")

    # -- the server tick ----------------------------------------------------

    def tick(self) -> None:
        """One server tick: poll and step every lobby, flush as waves."""
        self.ticks += 1
        self._m_ticks.inc()
        ph = self._phases
        ph.begin_tick()
        if self.pipeline:
            # last tick's landed checksum copies, before the polls publish them
            with ph.phase("readback_harvest"):
                self._rbq.harvest()
        per_lobby_ops = [self._collect_ops(b, s) for b, s in enumerate(self.sessions)]
        n_waves = max((len(ops) for ops in per_lobby_ops), default=0)
        self._last_wave = None
        self._last_adv = None
        for w in range(n_waves):
            wave_ops = [ops[w] if w < len(ops) else None for ops in per_lobby_ops]
            self._do_loads(wave_ops, per_lobby_ops, w)
            self._do_runs(wave_ops)
        if self.spec_caches is not None:
            self._speculate_idle_lanes()
        for b, s in enumerate(self.sessions):
            cf = s.confirmed_frame()
            self.confirmed[b] = cf
            self.rings[b].confirm(cf)
        if n_waves and not self.pipeline:
            # synchronous mode: read this tick's checksums before returning
            with ph.phase("readback_harvest"):
                BatchChecks.pull_pending(self.readbacks)
        if n_waves:
            # handshake-only ticks stay out of the flight ring; the stamps
            # feed the trace's counter tracks while the tick records
            if ph.on:
                ph.end_tick(frame=max(self.frames), lobbies=len(self.sessions),
                            device_bytes=devmem.total(),
                            pipeline_depth=self._rbq.depth() if self.pipeline else 0)
            else:
                ph.end_tick(frame=max(self.frames), lobbies=len(self.sessions))

    def _collect_ops(self, b: int, s) -> List[_Op]:
        with self._phases.phase("net_poll"):
            if hasattr(s, "poll_remote_clients"):
                s.poll_remote_clients()
            if hasattr(s, "events"):
                for ev in s.events():
                    self.events.append((b, ev))
                    if isinstance(ev, DesyncDetected):
                        self._report_desync(b, ev)
                    if self.on_event is not None:
                        self.on_event(b, ev)
        if isinstance(s, SyncTestSession):
            handles = list(range(s.num_players()))
        else:
            if s.current_state() != SessionState.RUNNING:
                return []  # still handshaking: poll only
            handles = list(s.local_player_handles())
        for h, v in self.read_inputs(b, handles).items():
            s.add_local_input(h, v)
        try:
            with self._phases.phase("session_step"), span("SessionAdvanceFrame"):
                requests = s.advance_frame()
        except MismatchedChecksumError as e:
            self._report_mismatch(b, e)
            return []
        except PredictionThresholdError:
            self.stalled[b] += 1
            if _REG.enabled:
                telemetry.count("stalled_frames_total", help="ticks skipped on stall",
                                kind="p2p", lobby=b)
                telemetry.record("stall", lobby=b, frame=self.frames[b],
                                 reason="prediction_threshold")
            return []
        except NotSynchronizedError:
            return []
        return _split_ops(requests)

    # -- loads --------------------------------------------------------------

    def _do_loads(self, wave_ops: List[Optional[_Op]],
                  per_lobby_ops: Optional[List[List[_Op]]] = None, w: int = 0) -> None:
        loads = [(b, op.load_frame, op.load_cause) for b, op in enumerate(wave_ops)
                 if op is not None and op.load_frame is not None]
        if not loads:
            return
        self.rollbacks += len(loads)
        ph = self._phases
        for b, f, _c in loads:
            ph.note_rollback(self.frames[b] - f)
        if _REG.enabled:
            self._note_loads(loads)
        # a Load whose following run was fully hedged is served from the
        # lobby's branch cache: the ring pop is bookkeeping, the world
        # restore one row write of the cached final, the run's saves views
        # of the branch stack, and the run op is consumed.  Partial hits
        # fall through to the miss path (serving them would split one run
        # across cache and wave, shifting the other lobbies' waves).
        hits: Dict[int, tuple] = {}
        if self.spec_caches is not None and per_lobby_ops is not None:
            for b, f, _c in loads:
                ops_b = per_lobby_ops[b]
                nxt = ops_b[w + 1] if w + 1 < len(ops_b) else None
                if nxt is None or not nxt.run:
                    continue
                advs = [r for r in nxt.run if isinstance(r, AdvanceRequest)]
                if not advs:
                    continue
                got = self.spec_caches[b].lookup_seq(f, np.stack([a.inputs for a in advs]))
                full = got is not None and got[0] == len(advs)
                if _REG.enabled:
                    telemetry.count("speculation_hits_total" if full
                                    else "speculation_misses_total",
                                    help="speculative branch-cache lookups")
                if full:
                    hits[b] = (f, got, nxt)
        if hits:
            t_hit = time.perf_counter()
            with ph.phase("rollback_load"), span("LoadWorldBatched"):
                for b, (f, (d, states_fn, checks_b), nxt) in hits.items():
                    stored, cs0 = self.rings[b].rollback(f)
                    self.spec_caches[b].invalidate_after(f)
                    cbc = BatchChecks(checks_b, self.readbacks)
                    self.worlds = _set_row(self.worlds, b, states_fn(d - 1))
                    self.device_dispatches += 1
                    self._m_dispatches.inc()
                    if self.pipeline:
                        self._rbq.start(cbc)
                    self._world_checksum[b] = cbc.ref(d - 1)
                    self.frames[b] = frame_add(f, d)
                    self.cache_served_frames += d
                    c = 0
                    for r in nxt.run:
                        if isinstance(r, AdvanceRequest):
                            c += 1
                        elif c == 0:
                            self.rings[b].push(r.frame, (stored, cs0))
                            r.cell.save(r.frame, cs0)
                        else:
                            cs = cbc.ref(c - 1)
                            self.rings[b].push(r.frame,
                                               (LazySlice(states_fn.stacked, c - 1), cs))
                            r.cell.save(r.frame, cs)
                    per_lobby_ops[b][w + 1] = None  # run consumed
                    if _REG.enabled:
                        telemetry.record("speculation_hit", lobby=b, frame=f, depth=d,
                                         advances=d)
            if _REG.enabled:
                self._observe_service("hit", t_hit)
        loads = [(b, f, c) for b, f, c in loads if b not in hits]
        if not loads:
            return
        t_miss = time.perf_counter()
        with ph.phase("rollback_load"), span("LoadWorldBatched"):
            # the mixed-source load: roll every ring back, group the stored
            # handles by backing buffer, one gather per buffer for the wave
            entries = rollback_many(self.rings, [(b, f) for b, f, _c in loads])
            groups, fallback = plan_row_gather([(b, stored) for b, (stored, _cs) in entries])
            if groups:
                self.worlds = fused_load_rows(self.worlds, groups, self._rows,
                                              self._load_transform)
                self.device_dispatches += 1
                self.fused_loads += 1
                self._m_dispatches.inc()
                self._m_fused_loads.inc()
            for b, stored in fallback:
                # rare: a ring entry that is a concrete world, not a lazy slice
                state = self.app.reg.load_state(materialize(stored))
                self.worlds = _set_row(self.worlds, b, state)
                self.device_dispatches += 1
                self.fallback_loads += 1
                self._m_dispatches.inc()
                self._m_fallback_loads.inc()
            for b, (_stored, cs) in entries:
                self._world_checksum[b] = cs
            for b, f, _c in loads:
                self.frames[b] = f
                if self.spec_caches is not None:
                    # branches hedged from superseded states must not serve
                    self.spec_caches[b].invalidate_after(f)
        if self.spec_caches is not None and _REG.enabled:
            self._observe_service("miss", t_miss)

    def _note_loads(self, loads) -> None:
        """Per-lobby rollback families and timeline events (telemetry on):
        a cause-less load blames ``"unknown"``, so ``rollback_cause_total``
        summed over handles equals ``rollbacks_total``."""
        for b, f, cause in loads:
            depth = self.frames[b] - f
            blamed = cause.handle if cause is not None else None
            if blamed is None:
                blamed = "unknown"
            lateness = cause.lateness if cause is not None else depth
            telemetry.count("rollbacks_total", lobby=b)
            telemetry.count("rollback_cause_total",
                            help="rollbacks attributed to the peer whose input caused them",
                            lobby=b, handle=blamed)
            telemetry.observe("rollback_depth", depth, lobby=b)
            telemetry.observe("input_lateness_frames", lateness,
                              "frames late the blamed input arrived", lobby=b, handle=blamed)
            telemetry.record("rollback", lobby=b, to_frame=f, from_frame=self.frames[b],
                             depth=depth, handle=blamed, lateness=lateness,
                             cause_kind=cause.kind if cause is not None else "unknown")

    @staticmethod
    def _observe_service(path: str, t0: float) -> None:
        telemetry.observe(
            "rollback_service_ms", (time.perf_counter() - t0) * 1e3,
            "wall ms to service one rollback (LoadRequest + its following "
            "Advance/Save run)", buckets=telemetry.LATENCY_MS_BUCKETS, path=path)

    # -- runs ---------------------------------------------------------------

    def _do_runs(self, wave_ops: List[Optional[_Op]]) -> None:
        m = len(self.sessions)
        runs = [op.run if op is not None else None for op in wave_ops]
        adv = [[r for r in (run or []) if isinstance(r, AdvanceRequest)] for run in runs]
        ks = [len(a) for a in adv]
        if not any(run for run in runs):
            return
        k_hot = max(ks)
        if k_hot > self.k_max:
            raise ValueError(f"lobby requested a {k_hot}-frame run > k_max={self.k_max}; "
                             "raise BatchedRunner(k_max=...)")
        stacked = batch = None
        bucket = 0
        pre_checksum = list(self._world_checksum)
        prev_worlds = self.worlds
        ph = self._phases
        if k_hot > 0:
            ph.note_advances(sum(ks))
            bucket = self.exec.bucket_for(k_hot)
            with ph.phase("stage_inputs"):
                if self.packed:
                    spec = self.app.packed_spec
                    for b, a in enumerate(adv):
                        lane = self._stage_packed[b]
                        # the prefix is rewritten EVERY wave: an idle lane
                        # must read n_real=0 whatever a past wave left behind
                        pack_prefix(lane, self.frames[b], len(a))
                        for i, x in enumerate(a):
                            pack_row(spec, lane, i, x.inputs, x.status)
                        repeat_last_row(lane, len(a), bucket)
                else:
                    inputs, status = self._stage_inputs, self._stage_status
                    self._stage_starts[:m] = self.frames
                    for b, a in enumerate(adv):
                        if not a:
                            continue
                        for i, x in enumerate(a):
                            inputs[b, i] = x.inputs
                            status[b, i] = x.status
                        inputs[b, len(a):bucket] = inputs[b, len(a) - 1]
                        status[b, len(a):bucket] = status[b, len(a) - 1]
            self.device_dispatches += 1
            self._m_dispatches.inc()
            self._m_resim_frames.inc(sum(max(k - 1, 0) for k in ks))
            if _REG.enabled:
                telemetry.record("dispatch", batched=True, k_hot=k_hot,
                                 active_lobbies=sum(1 for k in ks if k > 0))
            # sharded: the planner publishes the wave's per-shard shape, and
            # the executor sees the padded lane list (the resident world and
            # staging are padded already: no per-wave pad or trim)
            wave_ks = ks
            if self.planner is not None:
                self.planner.plan(ks)
                wave_ks = ks + [0] * (self._m_pad - m)
            with ph.phase("wave_dispatch"), span("AdvanceWorldBatched"):
                if self.packed:
                    bucket, finals, stacked, checks_flat = self.exec.run_wave_packed(
                        self.worlds, self._stage_packed, wave_ks)
                else:
                    bucket, finals, stacked, checks_flat = self.exec.run_wave(
                        self.worlds, inputs, status, self._stage_starts, wave_ks)
                batch = BatchChecks(checks_flat, self.readbacks)
                if self.pipeline:
                    self._rbq.start(batch)
                self.worlds = finals
                for b in range(m):
                    if ks[b] > 0:
                        self.frames[b] = frame_add(self.frames[b], ks[b])
                        self._world_checksum[b] = batch.ref(b * bucket + ks[b] - 1)
            if self.spec_caches is not None:
                self._last_wave = (prev_worlds, stacked, list(ks))
                self._last_adv = adv
        with ph.phase("store_save"), span("SaveWorldBatched"):
            saves = []  # (lobby, advances before the save, request)
            for b, run in enumerate(runs):
                c = 0
                for r in run or []:
                    if isinstance(r, AdvanceRequest):
                        c += 1
                    else:
                        saves.append((b, c, r))
            if not saves:
                return
            # a leading save rings a row of the pre-wave resident world
            # (still alive in prev_worlds); later saves rows of the stack
            handles = [LazySlice(prev_worlds, b) if c == 0 else LazySlice(stacked, (b, c - 1))
                       for b, c, _r in saves]
            if self._store_transform is not None:
                # non-identity strategy: every saved row's store_state in
                # one gathered stack; ring entries become views of it
                groups, _none = plan_row_gather(list(enumerate(handles)))
                stored_stack = fused_gather_rows(groups, self._rows, self._store_transform)
                order = np.concatenate([g[3] for g in groups])
                pos = np.empty_like(order)
                pos[order] = np.arange(len(order))
                handles = [LazySlice(stored_stack, int(pos[j])) for j in range(len(saves))]
                self.device_dispatches += 1
                self._m_dispatches.inc()
            for (b, c, r), stored in zip(saves, handles):
                cs = pre_checksum[b] if c == 0 else batch.ref(b * bucket + (c - 1))
                self.rings[b].push(r.frame, (stored, cs))
                r.cell.save(r.frame, cs)

    # -- speculative draft waves --------------------------------------------

    def _speculate_idle_lanes(self) -> None:
        """One extra packed wave that fills ONLY the lanes the tick's last
        run wave left idle (``ks[b] == 0``) with candidate-input draft
        branches, assigned by the :class:`~.ops.batch.DraftWaveScheduler`.

        Each assigned lane starts from its drafting lobby's pre-advance
        state (a gather into a copy of the resident world: the live state
        is never touched), advances its candidate row ``depth`` frames, and
        each lobby's cache gets a copy of its own lanes of the stack, as the
        JAX runner's ``a[lanes, :depth]`` does: an entry never pins the
        whole ``[M, bucket]`` wave stack, so the cache's byte budget bounds
        what it holds.  A tick with no idle lane, or no predicted last
        advance, drafts nothing."""
        if self._last_wave is None:
            return
        prev_worlds, stacked, ks = self._last_wave
        adv = self._last_adv
        m = len(self.sessions)
        cfg = self.spec_config
        depth = max(cfg.depth, 1)
        idle = [b for b in range(m) if ks[b] == 0]
        if not idle:
            return
        wants, cands_by_lobby = [], {}
        for b in range(m):
            if ks[b] == 0 or not np.any(np.asarray(adv[b][-1].status) == InputStatus.PREDICTED):
                continue
            cands = np.asarray(cfg.candidates_fn(adv[b][-1].inputs), self.app.input_dtype)
            if cands.shape[0]:
                cands_by_lobby[b] = cands
                wants.append((b, cands.shape[0]))
        if not wants:
            return
        plan = self._draft_sched.plan(idle, wants)
        if not plan:
            return
        # the state feeding each lobby's LAST advance: the second-newest
        # frame of its run, or the pre-wave resident row
        rows = [(lane, LazySlice(stacked, (b, ks[b] - 2)) if ks[b] >= 2
                 else LazySlice(prev_worlds, b)) for b, _ci, lane in plan]
        with self._phases.phase("wave_dispatch"), span("DraftWaveBatched"):
            groups, _fallback = plan_row_gather(rows)  # every row is a lazy slice
            draft_worlds = fused_load_rows(self.worlds, groups, self._rows)
            self.device_dispatches += 1
            self._m_dispatches.inc()
            spec = self.app.packed_spec
            packed = self._stage_packed_draft
            draft_ks = [0] * m
            zero_status = np.zeros((self._np,), np.int8)
            for b, ci, lane in plan:
                pack_prefix(packed[lane], frame_add(self.frames[b], -1), depth)
                pack_row(spec, packed[lane], 0, cands_by_lobby[b][ci], zero_status)
                repeat_last_row(packed[lane], 1, self._draft_bucket)
                draft_ks[lane] = depth
            for lane in range(m):
                if draft_ks[lane] == 0:
                    pack_prefix(packed[lane], 0, 0)
            bucket, _finals, d_stacked, d_checks = self.exec.run_wave_packed(
                draft_worlds, packed, draft_ks)
            self.device_dispatches += 1
            self._m_dispatches.inc()
            self.draft_waves += 1
            self._m_drafts.inc()
        checks_m = d_checks.view(m, bucket, 2)
        by_lobby: Dict[int, dict] = {}
        for b, ci, lane in plan:  # a duplicate candidate's lane is not kept
            by_lobby.setdefault(b, {}).setdefault(cands_by_lobby[b][ci].tobytes(), (ci, lane))
        for b, pairs in by_lobby.items():
            lanes = [lane for _ci, lane in pairs.values()]
            own = tree_map(lambda a: torch.stack([a[lane, :depth] for lane in lanes]), d_stacked)
            self.spec_caches[b].fill_from_branched(
                frame_add(self.frames[b], -1),
                np.stack([cands_by_lobby[b][ci] for ci, _lane in pairs.values()]), own,
                torch.stack([checks_m[lane, :depth] for lane in lanes]),
                offset=0, depth_eff=depth)

    # -- observability ------------------------------------------------------

    def _report_mismatch(self, b: int, e: MismatchedChecksumError) -> None:
        """Lobby SyncTest mismatch: timeline event and forensics report
        (when a directory is set), then ``on_mismatch`` (or the raise)."""
        telemetry.record("checksum_mismatch", source="synctest", lobby=b,
                         frames=list(e.mismatched_frames), current_frame=e.current_frame)
        if telemetry.forensics_dir() is not None:
            telemetry.write_desync_report("synctest_mismatch", reg=self.app.reg,
                                          world=self.lobby_world(b),
                                          frames=e.mismatched_frames, lobby=b)
        if self.on_mismatch is None:
            raise e
        self.on_mismatch(b, e)

    def _report_desync(self, b: int, ev: DesyncDetected) -> None:
        """Lobby ``DesyncDetected``: timeline event and forensics report
        (when a directory is set) with the lobby's resolved per-frame
        checksums, as the solo runner writes it."""
        telemetry.record("checksum_mismatch", source="p2p", lobby=b, frames=[ev.frame],
                         local_checksum=ev.local_checksum,
                         remote_checksum=ev.remote_checksum, addr=repr(ev.addr))
        if telemetry.forensics_dir() is None:
            return
        local = getattr(self.sessions[b], "_local_checksums", None) or {}
        telemetry.write_desync_report(
            "p2p_desync", reg=self.app.reg, world=self.lobby_world(b), frames=[ev.frame],
            local_checksum=ev.local_checksum, remote_checksum=ev.remote_checksum,
            addr=ev.addr, lobby=b,
            checksums={f: v for f, v in local.items() if isinstance(v, int)})

    def arm_compile_guard(self) -> bool:
        """Declare warmup over: with ``BGT_COMPILE_GUARD=1`` (or
        :func:`~bevy_ggrs_tpu_torch.utils.compile_guard.set_compile_guard`)
        any later wave-program first dispatch raises
        :class:`~bevy_ggrs_tpu_torch.utils.compile_guard.RecompileError`
        naming the owner/kind and bumps ``recompiles_steady_total{owner}``.
        Returns True when armed; no-op (False) when the guard is off."""
        return compile_guard.guard().arm()

    def stats(self) -> dict:
        """The runner's and the executor's counters: ticks, rollbacks, device
        dispatches (waves, fused loads, fallback rows, hit writes, stored
        stacks), per-lobby frames, uploads, checksum reads, and the
        speculation counters."""
        deferred, landed = self.exec.staging_waits()
        out = {
            "lobbies": len(self.sessions),
            "packed": self.packed,
            "pipeline": self.pipeline,
            "ticks": self.ticks,
            "rollbacks": self.rollbacks,
            "device_dispatches": self.device_dispatches,
            "fused_loads": self.fused_loads,
            "fallback_loads": self.fallback_loads,
            "load_index_uploads": self._rows.uploads,
            "stalled_frames": list(self.stalled),
            "frames": list(self.frames),
            "confirmed": list(self.confirmed),
            "readbacks": dataclasses.asdict(self.readbacks),
            "staging_deferred_blocks": deferred + self._rows.deferred_blocks,
            "staging_landed_free": landed + self._rows.landed_free,
        }
        if self.planner is not None:
            out["sharded"] = {
                "devices": self.planner.n_devices,
                "lanes_per_shard": self.planner.lanes_per_shard,
                "pad_lanes": self._m_pad - len(self.sessions),
                "imbalance_last": round(self.planner.last_imbalance, 4),
                "imbalance_max": round(self.planner.max_imbalance, 4),
                "waves_planned": self.planner.waves_planned,
            }
        if self.spec_caches is not None:
            out["speculation"] = {
                "hits": sum(c.hits for c in self.spec_caches),
                "misses": sum(c.misses for c in self.spec_caches),
                "draft_waves": self.draft_waves,
                "draft_lanes_filled": self._draft_sched.lanes_filled,
                "dropped_candidates": self._draft_sched.dropped_candidates,
                "cache_served_frames": self.cache_served_frames,
                # distinct storages: each lobby's entries pin its own lanes
                "cached_bytes": tree_storage_bytes([c._cache for c in self.spec_caches]),
            }
        out.update(self.exec.stats())
        return out

    def lobby_world(self, b: int):
        """Lobby ``b``'s live world (views of the resident world's row)."""
        return tree_index(self.worlds, b)

    def lobby_checksum(self, b: int) -> int:
        """Lobby ``b``'s live 64-bit world checksum (waits for the card
        unless its copy has landed)."""
        self._rbq.harvest()
        return self._world_checksum[b]()

    def finish(self) -> None:
        """Flush deferred checksum comparisons on every lobby session."""
        self._rbq.harvest()
        for b, s in enumerate(self.sessions):
            if hasattr(s, "check_now"):
                try:
                    s.check_now()
                except MismatchedChecksumError as e:
                    self._report_mismatch(b, e)
