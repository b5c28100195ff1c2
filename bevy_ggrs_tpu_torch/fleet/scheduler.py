"""Fleet scheduler: matchmaker + placement + admission + migration + failover.

Port of ``bevy_ggrs_tpu/fleet/scheduler.py`` (host code; the wire is the
JAX package's byte for byte, so either package's workers can register).
The scheduler needs no device: admission sizes lobbies on the CPU.

The :class:`FleetScheduler` is the control-plane brain promoted out of
``scripts/room_server.py``: one UDP endpoint that workers register and
heartbeat against, clients submit lobbies to, and that owns every placement
decision.  Like the room server it is entirely ``poll()``-driven and
non-blocking — run it from a loop, a thread, or ``scripts/torch_fleet_scheduler.py``.

Placement is greedy bin-packing over live heartbeat state: a lobby goes to
the *feasible* worker (slot free, bytes budget not exceeded) with the best
score — emptiest by slots first, then lowest estimated device-resident
bytes, then best reported QoS floor.  Infeasible everywhere = admission
reject, ON THE WIRE, with the reason (``capacity`` / ``memory`` /
``no_workers``) — a client is never left to infer rejection from silence,
and every reject increments ``admission_rejects_total{reason}``.

Live migration (:meth:`migrate`) is a drain-and-resume handshake pinned to
a confirmed-frame barrier: DRAIN(src, barrier) → the source advances
exactly TO the barrier, checkpoints (world + frame + input tail), ships it
here → RESUME(dst) + chunks → dst restores and RESUME_OK → DROP(src).
Downtime is measured scheduler-side — final-checkpoint-complete to
RESUME_OK arrival, both on this process's clock (cross-process monotonic
clocks are not comparable) — and observed into ``migration_downtime_ms``.
Bit-exactness across the handoff is a property of the lobby layer: catalog
apps run canonical-depth programs, so the split frame sequence reproduces
the unmigrated checksums exactly (fleet/lobby.py; gated in chip_smoke.py's
phase ``fleet``).

Failover reuses the migration tail: workers ship periodic confirmed
checkpoints (fleet/worker.py), so when heartbeats stop the scheduler
already holds a last-confirmed-frame artifact per lobby and re-resumes it
on a surviving worker — ``lobby_migrations_total{outcome="failover"}``.

Metric families (docs/observability.md "Fleet scheduling"):
``fleet_workers``, ``fleet_lobbies_placed_total``,
``lobby_migrations_total{outcome}``, ``admission_rejects_total{reason}``,
``migration_downtime_ms``."""

from __future__ import annotations

import dataclasses
import logging
import socket as _socket
import time
from typing import Dict, List, Optional, Tuple

from .. import telemetry
from ..telemetry.metrics import LATENCY_MS_BUCKETS
from . import protocol as P
from .lobby import LobbySpec, spec_est_bytes
from .observe import FleetObserver

log = logging.getLogger("bevy_ggrs_tpu_torch.fleet.scheduler")

WORKER_TIMEOUT_S = 2.0  # missed heartbeats -> dead -> failover
RESEND_S = 0.5  # control-command (DRAIN/RESUME/PLACE) retry interval
# per-worker device-bytes budget when the worker has not reported one;
# generous for CPU-backed test fleets, deliberately small enough that a
# handful of big lobbies exercises the memory-admission path
DEFAULT_MEM_BUDGET = 512 * 1024 * 1024


@dataclasses.dataclass
class WorkerInfo:
    """Live view of one registered worker (refreshed by heartbeats)."""

    worker_id: str
    addr: Tuple[str, int]
    capacity: int
    last_seen: float
    stats: dict = dataclasses.field(default_factory=dict)
    # canonical digest of ``stats`` — HB_SEQ liveness refreshes must prove
    # they describe the payload we already hold (fleet/protocol.py)
    stats_digest: str = ""

    def lobby_frames(self) -> Dict[str, int]:
        """Per-lobby frames from the latest heartbeat."""
        return {
            lid: int(st.get("frame", 0))
            for lid, st in (self.stats.get("lobbies") or {}).items()
        }

    def qos_floor(self) -> float:
        """Worst reported lobby QoS score (100 when idle)."""
        scores = (self.stats.get("lobby_qos_score") or {}).values()
        return min(scores, default=100.0)

    def device_bytes(self) -> int:
        """Reported device-resident bytes (0 until the first heartbeat)."""
        return int(self.stats.get("device_resident_bytes", 0))


@dataclasses.dataclass
class LobbyRecord:
    """Scheduler-side lifecycle record for one placed lobby."""

    lobby_id: str
    spec: LobbySpec
    worker_id: str
    est_bytes: int
    state: str = "placing"  # placing|running|migrating|failing_over|done
    frame: int = 0
    # latest confirmed checkpoint shipped by the hosting worker
    ckpt_frame: int = -1
    ckpt_blob: Optional[bytes] = None
    # migration in flight: destination worker + barrier + phase
    mig_dst: Optional[str] = None
    mig_barrier: int = -1
    mig_phase: str = ""  # draining | resuming
    mig_t_ckpt: float = 0.0
    last_cmd_sent: float = 0.0
    final_checksum: str = ""
    done_frame: int = -1
    # RESUME bursts sent for the resume in flight (protocol.reship_order)
    resume_rounds: int = 0


class FleetScheduler:
    """Multi-host matchmaker with QoS-aware placement, wire-visible
    admission control, live migration, and heartbeat-timeout failover."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 worker_timeout_s: float = WORKER_TIMEOUT_S,
                 mem_budget_bytes: int = DEFAULT_MEM_BUDGET,
                 observer: Optional[FleetObserver] = None):
        self._sock = _socket.socket(_socket.AF_INET, _socket.SOCK_DGRAM)
        self._sock.setblocking(False)
        self._sock.bind((host, port))
        self.worker_timeout_s = worker_timeout_s
        self.mem_budget_bytes = int(mem_budget_bytes)
        self.workers: Dict[str, WorkerInfo] = {}
        self.lobbies: Dict[str, LobbyRecord] = {}
        self._assembler = P.ChunkAssembler()
        # lobby_id -> client addr awaiting SUBMIT_OK/REJECT
        self._submitters: Dict[str, Tuple[str, int]] = {}
        self.events: List[dict] = []  # placement/migration/reject audit log
        # federation read side: heartbeat time-series + SLO burn alerts
        self.observer = observer if observer is not None else FleetObserver()

    @property
    def local_addr(self) -> Tuple[str, int]:
        """The bound (host, port) clients and workers should target."""
        return self._sock.getsockname()

    def close(self) -> None:
        """Release the socket (tests; the CLI just exits)."""
        self._sock.close()

    # -- outbound ----------------------------------------------------------

    def _send(self, data: bytes, addr) -> None:
        try:
            self._sock.sendto(data, addr)
        except OSError:
            pass

    def _send_worker(self, worker_id: str, data: bytes) -> None:
        w = self.workers.get(worker_id)
        if w is not None:
            self._send(data, w.addr)

    def _event(self, kind: str, **fields) -> None:
        self.events.append({"event": kind, **fields})

    def _wire(self, op: str, lid: str = "", worker: str = "",
              frame: int = 0) -> None:
        """Stamp one control-plane wire event onto the timeline's scheduler
        track — the N-way trace merge pairs these with the workers' side
        into flow arrows and clock-alignment anchors (telemetry/trace.py)."""
        telemetry.record("fleet_wire", track="scheduler", op=op, lid=lid,
                         worker=worker, frame=frame)

    # -- placement ---------------------------------------------------------

    def _assigned(self, worker_id: str) -> List[LobbyRecord]:
        return [
            r for r in self.lobbies.values()
            if r.worker_id == worker_id and r.state != "done"
        ]

    def _assigned_bytes(self, worker_id: str) -> int:
        return sum(r.est_bytes for r in self._assigned(worker_id))

    def _choose_worker(
        self, est_bytes: int, exclude: Tuple[str, ...] = ()
    ) -> Tuple[Optional[str], str]:
        """Greedy placement: best feasible worker, or (None, reason).

        Feasibility = free slot AND bytes headroom; score prefers the
        emptiest worker by slot fraction, then the least loaded by assigned
        bytes, then the best QoS floor — a cheap greedy bin-pack over live
        heartbeat state rather than an offline optimum, because workers
        join/die between any two polls anyway."""
        if not self.workers:
            return None, "no_workers"
        best, best_key = None, None
        saw_capacity_full = saw_memory_full = False
        for wid, w in self.workers.items():
            if wid in exclude:
                continue
            used = len(self._assigned(wid))
            if used >= w.capacity:
                saw_capacity_full = True
                continue
            if self._assigned_bytes(wid) + est_bytes > self.mem_budget_bytes:
                saw_memory_full = True
                continue
            key = (
                used / max(1, w.capacity),
                self._assigned_bytes(wid) + w.device_bytes(),
                -w.qos_floor(),
            )
            if best_key is None or key < best_key:
                best, best_key = wid, key
        if best is not None:
            return best, ""
        if saw_memory_full and not saw_capacity_full:
            return None, "memory"
        if saw_capacity_full:
            return None, "capacity"
        return None, "no_workers"

    def submit(self, spec: LobbySpec,
               client_addr: Optional[Tuple[str, int]] = None
               ) -> Tuple[bool, str]:
        """Admit-and-place one lobby (the SUBMIT path, also callable
        in-process).  Returns ``(admitted, worker_or_reason)``; wire
        submitters additionally get SUBMIT_OK / REJECT datagrams."""
        lid = spec.lobby_id
        if lid in self.lobbies and self.lobbies[lid].state != "done":
            reason = "duplicate"
            telemetry.count("admission_rejects_total",
                            help="fleet admissions refused, by reason",
                            reason=reason)
            self._event("reject", lobby=lid, reason=reason)
            if client_addr:
                self._send(P.encode_reject(lid, reason), client_addr)
            return False, reason
        est = spec_est_bytes(spec)
        wid, reason = self._choose_worker(est)
        if wid is None:
            telemetry.count("admission_rejects_total",
                            help="fleet admissions refused, by reason",
                            reason=reason)
            self._event("reject", lobby=lid, reason=reason)
            log.info("reject lobby %s: %s", lid, reason)
            if client_addr:
                self._send(P.encode_reject(lid, reason), client_addr)
            return False, reason
        rec = LobbyRecord(lobby_id=lid, spec=spec, worker_id=wid,
                          est_bytes=est)
        self.lobbies[lid] = rec
        if client_addr:
            self._submitters[lid] = client_addr
        self._place(rec)
        telemetry.count("fleet_lobbies_placed_total",
                        help="lobbies admitted and placed on a worker")
        self._event("place", lobby=lid, worker=wid, est_bytes=est)
        log.info("placed lobby %s on worker %s (est %d bytes)", lid, wid, est)
        return True, wid

    def _place(self, rec: LobbyRecord) -> None:
        rec.state = "placing"
        rec.last_cmd_sent = time.monotonic()
        self._send_worker(
            rec.worker_id, P.encode_place(rec.lobby_id, rec.spec.to_json())
        )
        self._wire("PLACE", rec.lobby_id, rec.worker_id)

    def drop(self, lobby_id: str) -> bool:
        """Tear a lobby down: DROP to its worker, forget the record (frees
        the slot for placement — the fleet smoke uses this to release its
        admission-probe filler lobbies)."""
        rec = self.lobbies.pop(lobby_id, None)
        if rec is None:
            return False
        self._send_worker(rec.worker_id, P.encode_drop(lobby_id))
        if rec.mig_dst:
            self._send_worker(rec.mig_dst, P.encode_drop(lobby_id))
        self._submitters.pop(lobby_id, None)
        self._event("drop", lobby=lobby_id, worker=rec.worker_id)
        return True

    # -- migration ---------------------------------------------------------

    def migrate(self, lobby_id: str, dst: Optional[str] = None,
                barrier_margin: int = 32) -> bool:
        """Start a live migration: drain at a confirmed-frame barrier ahead
        of the lobby's last reported frame, then resume on ``dst`` (chosen
        by placement when None).  Returns False (and counts a failed
        migration) when there is nowhere to go."""
        rec = self.lobbies.get(lobby_id)
        if rec is None or rec.state not in ("running", "placing"):
            return False
        if dst is None:
            dst, _reason = self._choose_worker(
                rec.est_bytes, exclude=(rec.worker_id,)
            )
        if dst is None or dst == rec.worker_id or dst not in self.workers:
            telemetry.count("lobby_migrations_total",
                            help="lobby migrations, by outcome",
                            outcome="failed")
            self._event("migrate_failed", lobby=lobby_id, reason="no_dst")
            return False
        rec.state = "migrating"
        rec.mig_dst = dst
        rec.mig_phase = "draining"
        # the barrier must sit at/ahead of the source's true frame; its
        # heartbeat view can lag, so pad by a margin — the worker clamps a
        # stale barrier up to its current frame anyway
        rec.mig_barrier = rec.frame + barrier_margin
        rec.last_cmd_sent = time.monotonic()
        self._send_worker(
            rec.worker_id, P.encode_drain(lobby_id, rec.mig_barrier)
        )
        self._wire("DRAIN", lobby_id, rec.worker_id, rec.mig_barrier)
        self._event("migrate_start", lobby=lobby_id, src=rec.worker_id,
                    dst=dst, barrier=rec.mig_barrier)
        log.info("migrating lobby %s: %s -> %s (barrier %d)",
                 lobby_id, rec.worker_id, dst, rec.mig_barrier)
        return True

    def _ship_resume(self, rec: LobbyRecord) -> None:
        """RESUME order + checkpoint chunks to the destination worker."""
        rec.last_cmd_sent = time.monotonic()
        self._send_worker(rec.mig_dst, P.encode_resume(
            rec.lobby_id, rec.ckpt_frame, rec.spec.to_json()
        ))
        self._wire("RESUME", rec.lobby_id, rec.mig_dst, rec.ckpt_frame)
        chunks = P.chunk_checkpoint(rec.lobby_id, rec.ckpt_frame, rec.ckpt_blob)
        for d in P.reship_order(chunks, rec.resume_rounds):
            self._send_worker(rec.mig_dst, d)
        rec.resume_rounds += 1

    def _finish_migration(self, rec: LobbyRecord, resumed_frame: int,
                          now: float) -> None:
        src = rec.worker_id
        downtime_ms = max(0.0, (now - rec.mig_t_ckpt) * 1000.0)
        telemetry.count("lobby_migrations_total",
                        help="lobby migrations, by outcome", outcome="ok")
        telemetry.observe("migration_downtime_ms", downtime_ms,
                          help="ckpt-complete to RESUME_OK, scheduler clock",
                          buckets=LATENCY_MS_BUCKETS)
        self._event("migrate_ok", lobby=rec.lobby_id, src=src,
                    dst=rec.mig_dst, frame=resumed_frame,
                    downtime_ms=round(downtime_ms, 3))
        self.observer.note_migration(rec.lobby_id, downtime_ms, now)
        log.info("migrated lobby %s: %s -> %s at frame %d (%.1f ms down)",
                 rec.lobby_id, src, rec.mig_dst, resumed_frame, downtime_ms)
        self._send_worker(src, P.encode_drop(rec.lobby_id))
        self._wire("DROP", rec.lobby_id, src, resumed_frame)
        rec.worker_id = rec.mig_dst
        rec.state = "running"
        rec.frame = resumed_frame
        rec.mig_dst = None
        rec.mig_phase = ""

    # -- failover ----------------------------------------------------------

    def _failover_worker(self, wid: str) -> None:
        """A worker stopped heartbeating: resume its lobbies elsewhere from
        their last confirmed checkpoints."""
        dead = self.workers.pop(wid, None)
        if dead is None:
            return
        log.warning("worker %s timed out; failing over its lobbies", wid)
        self._event("worker_dead", worker=wid)
        self._wire("FAILOVER", worker=wid)
        self.observer.forget_worker(wid, time.monotonic())
        for rec in list(self.lobbies.values()):
            if rec.worker_id != wid and rec.mig_dst != wid:
                continue
            if rec.state == "done":
                continue
            if rec.mig_dst == wid:  # migration destination died mid-flight
                rec.mig_dst = None
            if rec.ckpt_blob is None:
                # no confirmed checkpoint ever arrived (death before the
                # first ship): the only honest restart is from frame 0
                dst, _ = self._choose_worker(rec.est_bytes, exclude=(wid,))
                outcome = "restart" if dst else "failed"
                telemetry.count("lobby_migrations_total",
                                help="lobby migrations, by outcome",
                                outcome=outcome)
                self._event("failover_" + outcome, lobby=rec.lobby_id,
                            src=wid, dst=dst, frame=0)
                if dst:
                    rec.worker_id = dst
                    self._place(rec)
                continue
            dst, _ = self._choose_worker(rec.est_bytes, exclude=(wid,))
            if dst is None:
                telemetry.count("lobby_migrations_total",
                                help="lobby migrations, by outcome",
                                outcome="failed")
                self._event("failover_failed", lobby=rec.lobby_id, src=wid)
                continue
            rec.state = "failing_over"
            rec.mig_dst = dst
            rec.mig_phase = "resuming"
            rec.mig_t_ckpt = time.monotonic()
            rec.resume_rounds = 0
            self._ship_resume(rec)
            telemetry.count("lobby_migrations_total",
                            help="lobby migrations, by outcome",
                            outcome="failover")
            self._event("failover", lobby=rec.lobby_id, src=wid, dst=dst,
                        frame=rec.ckpt_frame)
            log.info("failover lobby %s: %s -> %s from confirmed frame %d",
                     rec.lobby_id, wid, dst, rec.ckpt_frame)

    # -- inbound -----------------------------------------------------------

    def _handle(self, msg: P.Msg, addr, now: float) -> None:
        if msg.kind == P.T_REGISTER:
            w = self.workers.get(msg.a)
            if w is None:
                log.info("worker %s registered (capacity %d)", msg.a,
                         msg.total)
                self._event("register", worker=msg.a, capacity=msg.total)
            self.workers[msg.a] = WorkerInfo(
                worker_id=msg.a, addr=addr, capacity=msg.total,
                last_seen=now, stats=w.stats if w else {},
                stats_digest=w.stats_digest if w else "",
            )
            # ack by echoing a heartbeat-shaped no-op? not needed: any
            # PLACE/heartbeat response proves liveness; workers treat any
            # inbound datagram as the register ack, so send a CKPT_ACK
            # no-op would be misleading — instead the first PLACE acks.
        elif msg.kind == P.T_HEARTBEAT:
            w = self.workers.get(msg.a)
            if w is None:  # heartbeat before/instead of REGISTER: adopt
                cap = int((msg.obj or {}).get("capacity", 1))
                w = WorkerInfo(worker_id=msg.a, addr=addr, capacity=cap,
                               last_seen=now)
                self.workers[msg.a] = w
            w.addr = addr
            w.last_seen = now
            w.stats = msg.obj or {}
            w.stats_digest = P.stats_digest(w.stats)
            for lid, frame in w.lobby_frames().items():
                rec = self.lobbies.get(lid)
                if rec is not None and rec.worker_id == msg.a:
                    rec.frame = max(rec.frame, frame)
            self.observer.ingest_heartbeat(
                msg.a, w.stats, now,
                assigned_slots=len(self._assigned(msg.a)),
            )
        elif msg.kind == P.T_HEARTBEAT_SEQ:
            w = self.workers.get(msg.a)
            # liveness refresh iff the digest proves the stats we already
            # hold; unknown workers / stale digests are ignored — the
            # worker's periodic forced full heartbeat re-adopts within
            # FULL_HEARTBEAT_EVERY beats (fleet/worker.py)
            if w is not None and msg.b == w.stats_digest:
                w.addr = addr
                w.last_seen = now
                self.observer.ingest_liveness(msg.a, now)
        elif msg.kind == P.T_PLACE_OK:
            rec = self.lobbies.get(msg.a)
            if rec is not None and rec.state == "placing":
                rec.state = "running"
                rec.frame = max(rec.frame, msg.frame)
                caddr = self._submitters.pop(msg.a, None)
                if caddr:
                    self._send(
                        P.encode_submit_ok(msg.a, rec.worker_id), caddr
                    )
        elif msg.kind == P.T_CKPT:
            self._on_ckpt_chunk(msg, now)
        elif msg.kind == P.T_RESUME_OK:
            rec = self.lobbies.get(msg.a)
            # mig_dst can be None if the destination died mid-resume and no
            # replacement existed yet; a late RESUME_OK must not complete
            # the handoff to nowhere — the retry loop re-picks a dst
            if (rec is not None and rec.mig_phase == "resuming"
                    and rec.mig_dst is not None):
                if rec.state == "failing_over":
                    # failover downtime is dominated by the timeout window,
                    # not the resume — keep the histogram for migrations
                    self._event("failover_ok", lobby=msg.a,
                                dst=rec.mig_dst, frame=msg.frame)
                    self._send_worker(rec.worker_id, P.encode_drop(msg.a))
                    rec.worker_id = rec.mig_dst
                    rec.state = "running"
                    rec.frame = msg.frame
                    rec.mig_dst = None
                    rec.mig_phase = ""
                else:
                    self._finish_migration(rec, msg.frame, now)
        elif msg.kind == P.T_SUBMIT:
            spec = LobbySpec.from_json(msg.obj)
            if spec.lobby_id != msg.a:
                spec = dataclasses.replace(spec, lobby_id=msg.a)
            self.submit(spec, client_addr=addr)
        elif msg.kind == P.T_DONE:
            rec = self.lobbies.get(msg.a)
            # workers re-announce DONE at heartbeat cadence (loss
            # tolerance): record the audit event on the transition only
            if rec is not None and rec.state != "done":
                rec.state = "done"
                rec.frame = msg.frame
                rec.done_frame = msg.frame
                rec.final_checksum = msg.b
                self._event("done", lobby=msg.a, frame=msg.frame,
                            checksum=msg.b)

    def _on_ckpt_chunk(self, msg: P.Msg, now: float) -> None:
        rec = self.lobbies.get(msg.a)
        if rec is None:
            return
        blob = self._assembler.offer(msg)
        # ack per-chunk-completion only: one ack per completed (lobby,
        # frame) keeps re-ship traffic bounded without per-chunk acks
        if blob is None:
            return
        self._send_worker(rec.worker_id, P.encode_ckpt_ack(msg.a, msg.frame))
        if msg.frame >= rec.ckpt_frame:
            rec.ckpt_frame = msg.frame
            rec.ckpt_blob = blob
        if (rec.state == "migrating" and rec.mig_phase == "draining"
                and msg.frame >= rec.mig_barrier):
            # the barrier checkpoint is in hand: downtime clock starts now
            rec.mig_t_ckpt = now
            rec.mig_phase = "resuming"
            rec.resume_rounds = 0
            # the CKPT instant anchors the downtime-spanning flow arrow
            # (CKPT -> destination RESUME_OK) in merged fleet traces
            self._wire("CKPT", rec.lobby_id, rec.worker_id, msg.frame)
            self._ship_resume(rec)

    # -- main loop ---------------------------------------------------------

    def _retries(self, now: float) -> None:
        for rec in self.lobbies.values():
            if now - rec.last_cmd_sent < RESEND_S:
                continue
            if rec.state == "placing":
                self._place(rec)
            elif rec.state == "migrating" and rec.mig_phase == "draining":
                rec.last_cmd_sent = now
                self._send_worker(
                    rec.worker_id,
                    P.encode_drain(rec.lobby_id, rec.mig_barrier),
                )
            elif rec.mig_phase == "resuming":
                if rec.mig_dst is None:
                    # the destination died mid-resume and no replacement was
                    # available at failover time: keep trying as workers
                    # (re-)appear
                    dst, _ = self._choose_worker(rec.est_bytes)
                    if dst is None:
                        continue
                    rec.mig_dst = dst
                self._ship_resume(rec)

    def poll(self) -> None:
        """One control quantum: drain the socket, detect dead workers and
        fail their lobbies over, re-send unacked commands, refresh gauges."""
        while True:
            try:
                data, addr = self._sock.recvfrom(65536)
            except (BlockingIOError, OSError):
                break
            msg = P.decode(data)
            if msg is not None:
                self._handle(msg, addr, time.monotonic())
            else:
                P.note_malformed(addr)
        now = time.monotonic()
        for wid, w in list(self.workers.items()):
            if now - w.last_seen > self.worker_timeout_s:
                self._failover_worker(wid)
        self._retries(now)
        telemetry.gauge_set("fleet_workers", len(self.workers),
                            help="live registered fleet workers")
        # throttled SLO evaluation + /fleet topology refresh (the observer
        # no-ops until its eval interval elapses)
        self.observer.tick(now, topology=self.snapshot)

    def run(self, duration_s: Optional[float] = None,
            idle_sleep_s: float = 0.005) -> None:
        """Poll until ``duration_s`` elapses (forever when None) — the
        ``scripts/torch_fleet_scheduler.py`` main loop."""
        t0 = time.monotonic()
        while duration_s is None or time.monotonic() - t0 < duration_s:
            self.poll()
            time.sleep(idle_sleep_s)

    # -- introspection -----------------------------------------------------

    def snapshot(self) -> dict:
        """JSON-able fleet state: workers, lobbies, audit events (the fleet
        smoke + scripts/torch_fleet_scheduler.py --status)."""
        return {
            "workers": {
                wid: {
                    "capacity": w.capacity,
                    "assigned": len(self._assigned(wid)),
                    "assigned_bytes": self._assigned_bytes(wid),
                    "qos_floor": w.qos_floor(),
                    "device_resident_bytes": w.device_bytes(),
                }
                for wid, w in self.workers.items()
            },
            "lobbies": {
                lid: {
                    "worker": r.worker_id,
                    "state": r.state,
                    "frame": r.frame,
                    "ckpt_frame": r.ckpt_frame,
                    "final_checksum": r.final_checksum,
                }
                for lid, r in self.lobbies.items()
            },
            "events": list(self.events),
        }

    def fleet_snapshot(self, tail: int = 32) -> dict:
        """The federated ``/fleet`` JSON (fleet/observe.py schema): refresh
        the observer's topology from this thread's live state, then return
        its snapshot.  HTTP handler threads must NOT call this — they use
        ``observer.fleet_snapshot()`` directly (topology is refreshed by
        :meth:`poll` at the observer's eval cadence), because only the poll
        thread may read ``self.workers`` / ``self.lobbies``."""
        self.observer.set_topology(self.snapshot())
        return self.observer.fleet_snapshot(tail=tail)


class FleetClient:
    """Wire client for SUBMIT: asks the scheduler to place a lobby and
    reports the wire-visible verdict (the admission-control test surface)."""

    def __init__(self, scheduler_addr: Tuple[str, int]):
        self.scheduler_addr = scheduler_addr
        self._sock = _socket.socket(_socket.AF_INET, _socket.SOCK_DGRAM)
        self._sock.setblocking(False)
        self._sock.bind(("127.0.0.1", 0))
        self.last_reject: str = ""

    def close(self) -> None:
        """Release the socket."""
        self._sock.close()

    def submit(self, spec: LobbySpec, timeout_s: float = 5.0,
               resend_s: float = 0.25) -> Optional[str]:
        """Submit ``spec``; block (bounded) for the verdict.  Returns the
        hosting worker_id on SUBMIT_OK, None on REJECT (reason in
        :attr:`last_reject`) or timeout (``last_reject == "timeout"``)."""
        self.last_reject = ""
        deadline = time.monotonic() + timeout_s
        next_send = 0.0
        while time.monotonic() < deadline:
            now = time.monotonic()
            if now >= next_send:
                next_send = now + resend_s
                try:
                    self._sock.sendto(
                        P.encode_submit(spec.lobby_id, spec.to_json()),
                        self.scheduler_addr,
                    )
                except OSError:
                    pass
            try:
                data, addr = self._sock.recvfrom(65536)
            except (BlockingIOError, OSError):
                time.sleep(0.01)
                continue
            msg = P.decode(data)
            if msg is None:
                P.note_malformed(addr)
                continue
            if msg.a != spec.lobby_id:
                continue
            if msg.kind == P.T_SUBMIT_OK:
                return msg.b
            if msg.kind == P.T_REJECT:
                self.last_reject = msg.b
                return None
        self.last_reject = "timeout"
        return None
