"""Fleet worker: one host process that registers, heartbeats, and runs lobbies.

Port of ``bevy_ggrs_tpu/fleet/worker.py``.  A worker holds one device and
hosts its lobbies there: CUDA unless given ``device="cpu"``, and without a
card it raises at construction, never stepping on the CPU by itself.

A :class:`FleetWorker` owns a UDP socket and a dict of hosted
:class:`~.lobby.LobbySim` instances.  Drive it with :meth:`poll` from a loop
(or :meth:`run` in the ``scripts/torch_fleet_worker.py`` CLI); each poll drains
the socket (PLACE / DRAIN / RESUME / DROP from the scheduler), advances
every runnable lobby by a bounded frame budget, then does the periodic
housekeeping: heartbeats, checkpoint shipping, DONE reports.

Reliability posture (everything is UDP): the worker, not the scheduler, is
the retry engine for its own uplink — REGISTER repeats until any scheduler
datagram arrives, heartbeats repeat forever, and every checkpoint re-ships
on a timer until the scheduler's CKPT_ACK for that exact (lobby, frame)
lands.  Scheduler-to-worker commands are likewise idempotent on this side:
a re-PLACE of a hosted lobby just re-sends PLACE_OK, a re-DRAIN re-ships
the barrier checkpoint.

Checkpoint shipping doubles as the failover plan: every
``ckpt_every_frames`` simulated frames the worker cuts a confirmed
checkpoint (world + frame + input tail, snapshot/persist.py) and ships it
to the scheduler, so when this process dies without warning the scheduler
holds a last-confirmed-frame artifact to resume from (see
fleet/scheduler.py failover)."""

from __future__ import annotations

import dataclasses
import logging
import socket as _socket
import time
from typing import Dict, Optional, Tuple

from .. import telemetry
from ..utils.device import DeviceLike, resolve_device
from . import protocol as P
from .lobby import LOBBY_CHUNK, LobbySim, LobbySpec, checksum_hex

log = logging.getLogger("bevy_ggrs_tpu_torch.fleet.worker")

HEARTBEAT_S = 0.25  # control-plane cadence (low-rate by design)
CKPT_RESHIP_S = 0.5  # unacked checkpoint retry interval
CKPT_EVERY_FRAMES = 120  # periodic confirmed-checkpoint cadence
# digest-suppressed heartbeats: force a full stats payload every N beats so
# a lost full (or a restarted scheduler that never saw one) self-heals
# within N * heartbeat_s instead of stranding liveness on a stale digest
FULL_HEARTBEAT_EVERY = 8


@dataclasses.dataclass
class _Shipment:
    """One in-flight checkpoint upload: re-sent until CKPT_ACKed."""

    frame: int
    datagrams: list
    last_sent: float = 0.0
    acked: bool = False
    rounds: int = 0  # bursts sent (each in protocol.reship_order)


class _Hosted:
    """Book-keeping wrapper around one hosted LobbySim."""

    def __init__(self, sim: LobbySim):
        self.sim = sim
        self.state = "running"  # running | draining | drained | done
        self.barrier: Optional[int] = None
        self.shipment: Optional[_Shipment] = None
        self.last_ckpt_frame = 0
        self.done_sent = False
        self.final_checksum: Optional[int] = None
        # realtime pacing anchor: (wall time, sim frame) at hosting start —
        # restored lobbies anchor at their restore frame, not 0
        self.pace_anchor = (time.monotonic(), sim.frame)


class FleetWorker:
    """One fleet host: registers with the scheduler, runs placed lobbies,
    drains/ships/restores them on command.

    ``step_budget`` bounds how many frames each lobby advances per poll so
    one long lobby cannot starve the control plane of polls.

    ``pace_fps`` > 0 caps each RUNNING lobby to realtime cadence (a game
    ticks at a fixed rate; an unpaced CPU sim clears a whole match between
    two heartbeats, which makes scheduler frame knowledge useless).
    Draining is deliberately unpaced: once a migration barrier is set the
    only goal is to reach it, and every paced frame there is pure added
    downtime.

    ``device`` is where the hosted lobbies live (``None`` = CUDA; raises
    here without a card)."""

    def __init__(
        self,
        worker_id: str,
        scheduler_addr: Tuple[str, int],
        capacity: int = 4,
        host: str = "127.0.0.1",
        port: int = 0,
        heartbeat_s: float = HEARTBEAT_S,
        ckpt_every_frames: int = CKPT_EVERY_FRAMES,
        step_budget: int = LOBBY_CHUNK,
        pace_fps: float = 0.0,
        device: DeviceLike = None,
    ):
        self.worker_id = worker_id
        self.scheduler_addr = scheduler_addr
        self.capacity = int(capacity)
        self.heartbeat_s = heartbeat_s
        self.ckpt_every_frames = int(ckpt_every_frames)
        self.step_budget = int(step_budget)
        self.pace_fps = float(pace_fps)
        self.device = resolve_device(device)
        self.lobbies: Dict[str, _Hosted] = {}
        # RESUME orders awaiting their checkpoint chunks:
        # lobby_id -> (frame, LobbySpec)
        self._resuming: Dict[str, Tuple[int, LobbySpec]] = {}
        self._assembler = P.ChunkAssembler()
        self._last_heartbeat = 0.0
        self._registered_ack = False
        # heartbeat suppression state: last full stats payload + its digest
        self._last_stats: Optional[dict] = None
        self._last_digest = ""
        self._hb_seq = 0
        self._beats_since_full = 0
        self._sock = _socket.socket(_socket.AF_INET, _socket.SOCK_DGRAM)
        self._sock.setblocking(False)
        self._sock.bind((host, port))

    @property
    def local_addr(self) -> Tuple[str, int]:
        """The bound (host, port) of the worker socket."""
        return self._sock.getsockname()

    def close(self) -> None:
        """Release the socket (tests; the CLI just exits)."""
        self._sock.close()

    # -- outbound ----------------------------------------------------------

    def _send(self, data: bytes) -> None:
        try:
            self._sock.sendto(data, self.scheduler_addr)
        except OSError:
            pass  # scheduler gone; heartbeat/reship timers keep retrying

    def _wire(self, op: str, lid: str = "", frame: int = 0) -> None:
        """Stamp one control-plane wire event onto the timeline — merged
        fleet traces pair these with the scheduler's side into flow arrows
        (telemetry/trace.py) and use the pairs for clock alignment."""
        telemetry.record("fleet_wire", track=f"worker:{self.worker_id}",
                         op=op, lid=lid, frame=frame)

    def register(self) -> None:
        """(Re-)announce this worker; repeated until the scheduler talks
        back (any inbound datagram counts as the ack)."""
        self._send(P.encode_register(self.worker_id, self.capacity))

    def _stats(self) -> dict:
        """The heartbeat JSON: capacity, per-lobby status, load signals."""
        lob = {}
        remaining = []
        for lid, h in self.lobbies.items():
            lob[lid] = {"frame": h.sim.frame, "state": h.state}
            remaining.append(
                max(0, h.sim.spec.target_frames - h.sim.frame)
            )
        # load-skew signal for placement: busiest lobby's remaining frames
        # over the mean (1.0 = balanced / idle), same max-over-mean shape as
        # the ShardPlanner's shard_imbalance_ratio gauge
        mean = sum(remaining) / len(remaining) if remaining else 0.0
        imbalance = (max(remaining) / mean) if mean > 0 else 1.0
        qos = telemetry.qos_snapshot()["lobby_qos_score"]
        return {
            "capacity": self.capacity,
            "lobbies": lob,
            "shard_imbalance_ratio": round(imbalance, 4),
            "device_resident_bytes": telemetry.devmem.total(),
            "lobby_qos_score": {
                lid: qos.get(lid, qos.get("default", 100.0))
                for lid in self.lobbies
            },
        }

    def _heartbeat(self, now: float) -> None:
        if now - self._last_heartbeat < self.heartbeat_s:
            return
        self._last_heartbeat = now
        if not self._registered_ack:
            self.register()
        stats = self._stats()
        self._hb_seq += 1
        if (stats == self._last_stats
                and self._beats_since_full < FULL_HEARTBEAT_EVERY):
            # unchanged payload: skip the JSON re-serialize and ship a
            # liveness-only HB_SEQ carrying the last full payload's digest
            self._beats_since_full += 1
            self._send(P.encode_heartbeat_seq(
                self.worker_id, self._hb_seq, self._last_digest
            ))
            telemetry.count(
                "fleet_heartbeat_suppressed_total",
                help="liveness-only heartbeats sent in place of an "
                     "unchanged stats payload",
            )
        else:
            self._last_stats = stats
            self._last_digest = P.stats_digest(stats)
            self._beats_since_full = 0
            self._send(P.encode_heartbeat(self.worker_id, stats))
        # re-announce finished lobbies at heartbeat cadence: DONE has no
        # ack type, so a lost datagram must not strand the scheduler in
        # "running" forever (the lobby stays hosted until DROP anyway)
        for lid, h in self.lobbies.items():
            if h.state == "done" and h.done_sent:
                self._send(P.encode_done(
                    lid, h.sim.frame, checksum_hex(h.final_checksum)
                ))

    # -- inbound -----------------------------------------------------------

    def _handle(self, msg: P.Msg) -> None:
        # any scheduler datagram proves the REGISTER got through
        self._registered_ack = True
        if msg.kind == P.T_PLACE:
            self._on_place(msg)
        elif msg.kind == P.T_DRAIN:
            self._on_drain(msg)
        elif msg.kind == P.T_RESUME:
            self._on_resume(msg)
        elif msg.kind == P.T_CKPT:
            self._on_ckpt_chunk(msg)
        elif msg.kind == P.T_CKPT_ACK:
            h = self.lobbies.get(msg.a)
            if h and h.shipment and h.shipment.frame == msg.frame:
                h.shipment.acked = True
        elif msg.kind == P.T_DROP:
            if msg.a in self.lobbies:
                log.info("worker %s: dropping lobby %s", self.worker_id, msg.a)
                del self.lobbies[msg.a]
                self._wire("DROP_RECV", msg.a)
            self._resuming.pop(msg.a, None)

    def _on_place(self, msg: P.Msg) -> None:
        if msg.a in self.lobbies:  # idempotent re-PLACE
            self._send(P.encode_place_ok(msg.a, self.lobbies[msg.a].sim.frame))
            return
        spec = LobbySpec.from_json(msg.obj)
        sim = LobbySim(spec, device=self.device)
        self.lobbies[msg.a] = _Hosted(sim)
        log.info("worker %s: placed lobby %s (%s, %d entities)",
                 self.worker_id, msg.a, spec.app, spec.entities)
        self._send(P.encode_place_ok(msg.a, sim.frame))
        self._wire("PLACE_OK", msg.a, sim.frame)

    def _on_drain(self, msg: P.Msg) -> None:
        h = self.lobbies.get(msg.a)
        if h is None:
            return
        if h.state == "drained" and h.barrier == msg.frame:
            self._reship(h, time.monotonic(), force=True)  # lost CKPT? again
            return
        # a barrier at or behind the current frame drains immediately AT the
        # current frame (the scheduler's view can lag a heartbeat)
        h.state = "draining"
        h.barrier = max(msg.frame, h.sim.frame)

    def _on_resume(self, msg: P.Msg) -> None:
        if msg.a in self.lobbies:  # idempotent re-RESUME after completion
            self._send(P.encode_resume_ok(msg.a, self.lobbies[msg.a].sim.frame))
            return
        self._resuming[msg.a] = (msg.frame, LobbySpec.from_json(msg.obj))

    def _on_ckpt_chunk(self, msg: P.Msg) -> None:
        order = self._resuming.get(msg.a)
        if order is None or order[0] != msg.frame:
            return
        blob = self._assembler.offer(msg)
        if blob is None:
            return
        frame, spec = self._resuming.pop(msg.a)
        sim = LobbySim.restore(spec, blob, device=self.device)
        h = _Hosted(sim)
        h.last_ckpt_frame = sim.frame
        self.lobbies[msg.a] = h
        log.info("worker %s: resumed lobby %s at frame %d",
                 self.worker_id, msg.a, sim.frame)
        self._send(P.encode_resume_ok(msg.a, sim.frame))
        self._wire("RESUME_OK", msg.a, sim.frame)
        # a restore (app build + first-step compile) can stall this worker
        # past the scheduler's heartbeat timeout; heartbeat immediately so
        # the stall window is as small as the work, not work + cadence
        self._last_heartbeat = 0.0

    # -- checkpoint shipping ----------------------------------------------

    def _cut_shipment(self, lid: str, h: _Hosted) -> None:
        blob = h.sim.checkpoint_bytes()
        h.shipment = _Shipment(
            frame=h.sim.frame,
            datagrams=P.chunk_checkpoint(lid, h.sim.frame, blob),
        )
        h.last_ckpt_frame = h.sim.frame

    def _reship(self, h: _Hosted, now: float, force: bool = False) -> None:
        s = h.shipment
        if s is None or (s.acked and not force):
            return
        if not force and now - s.last_sent < CKPT_RESHIP_S:
            return
        s.last_sent = now
        s.acked = s.acked and not force
        for d in P.reship_order(s.datagrams, s.rounds):
            self._send(d)
        s.rounds += 1

    # -- main loop ---------------------------------------------------------

    def _advance(self, lid: str, h: _Hosted) -> None:
        if h.state == "running":
            budget = self.step_budget
            if self.pace_fps > 0:
                t0, f0 = h.pace_anchor
                now = time.monotonic()
                allowed = f0 + int((now - t0) * self.pace_fps)
                if allowed - h.sim.frame > self.step_budget:
                    # fell behind realtime (first-step compile, restore):
                    # don't fast-forward the backlog — re-anchor at the
                    # present, exactly like a game dropping missed ticks
                    h.pace_anchor = (now, h.sim.frame)
                    allowed = h.sim.frame + self.step_budget
                budget = min(budget, allowed - h.sim.frame)
        elif h.state == "draining":
            budget = min(self.step_budget, h.barrier - h.sim.frame)
        else:
            return
        if budget > 0:
            h.sim.step(budget)
        if h.state == "draining" and h.sim.frame >= h.barrier:
            # at the barrier: cut + ship the migration checkpoint
            self._cut_shipment(lid, h)
            self._reship(h, time.monotonic(), force=True)
            h.state = "drained"
            self._wire("DRAINED", lid, h.barrier)
            log.info("worker %s: drained lobby %s at barrier %d",
                     self.worker_id, lid, h.barrier)
            return
        if h.state == "running":
            if h.sim.done:
                h.state = "done"
                h.final_checksum = h.sim.checksum()
            elif (h.sim.frame - h.last_ckpt_frame >= self.ckpt_every_frames
                  and (h.shipment is None or h.shipment.acked)):
                # periodic confirmed checkpoint: the scheduler's failover
                # source.  Never more than one unacked upload per lobby
                self._cut_shipment(lid, h)

    def poll(self) -> None:
        """One scheduling quantum: drain the socket, advance lobbies by the
        step budget, ship/re-ship checkpoints, heartbeat, report DONEs."""
        while True:
            try:
                data, addr = self._sock.recvfrom(65536)
            except (BlockingIOError, OSError):
                break
            msg = P.decode(data)
            if msg is not None:
                self._handle(msg)
            else:
                P.note_malformed(addr)
        for lid, h in list(self.lobbies.items()):
            self._advance(lid, h)
            now = time.monotonic()
            self._reship(h, now)
            # heartbeat BETWEEN lobby advances too: a poll over several
            # freshly-placed lobbies runs their first-step compiles
            # back-to-back, and the un-interleaved stall was long enough
            # to get a healthy worker declared dead
            self._heartbeat(now)
            if h.state == "done" and not h.done_sent:
                self._send(P.encode_done(
                    lid, h.sim.frame, checksum_hex(h.final_checksum)
                ))
                h.done_sent = True
                log.info("worker %s: lobby %s done at frame %d (%s)",
                         self.worker_id, lid, h.sim.frame,
                         checksum_hex(h.final_checksum))
        self._heartbeat(time.monotonic())

    def run(self, duration_s: Optional[float] = None,
            idle_sleep_s: float = 0.005) -> None:
        """Poll until ``duration_s`` elapses (forever when None) — the
        ``scripts/torch_fleet_worker.py`` main loop."""
        self.register()
        t0 = time.monotonic()
        while duration_s is None or time.monotonic() - t0 < duration_s:
            self.poll()
            time.sleep(idle_sleep_s)
