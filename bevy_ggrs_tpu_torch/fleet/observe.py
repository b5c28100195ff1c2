"""Fleet-wide telemetry federation: scheduler-side time-series + SLO alerts.

Port of ``bevy_ggrs_tpu/fleet/observe.py`` over the port's ``telemetry``
(the same metric families, schemas and SLO semantics).

The workers already report rich heartbeat stats (capacity, per-lobby
frames, ``shard_imbalance_ratio``, ``lobby_qos_score``,
``device_resident_bytes`` — fleet/worker.py ``_stats``), but until this
module the scheduler consumed them for placement and dropped them on the
floor.  :class:`FleetObserver` is the read side the ROADMAP-item-1
rebalancer will subscribe to:

- **Time-series rings** — every heartbeat appends bounded ``(t, value)``
  samples per worker (QoS floor, imbalance, device bytes, assigned slots,
  heartbeat gap) and per lobby (QoS, frame), queryable with
  :meth:`SeriesRing.window` / :meth:`SeriesRing.rate`.  The same ingest
  refreshes ``worker=`` / ``lobby=`` labeled gauges on the default
  registry, so a single scheduler-side ``/metrics`` scrape federates the
  whole fleet's load signals.
- **SLO engine** — declarative objectives (:class:`SLO`): a per-lobby QoS
  floor with burn-rate evaluation over a sliding window, a
  migration-downtime ceiling, and per-worker heartbeat liveness.  Breaches
  must SUSTAIN for ``burn_window_s`` before an alert fires (one bad sample
  is not an incident) and must stay clean for ``resolve_window_s`` before
  it resolves (hysteresis); fire/resolve transitions are deduplicated
  per ``(slo, subject)``, appended as typed :class:`AlertEvent` records,
  counted into ``fleet_alerts_total{slo,state}``, and stamped onto the
  timeline as ``fleet_alert`` instants (visible in merged fleet traces —
  telemetry/trace.py).
- **HTTP federation** — :func:`fleet_routes` / :func:`start_fleet_exporter`
  extend the Prometheus exporter with ``/fleet`` (topology + series
  snapshot + alerts, the one schema the scheduler CLI also prints) and a
  fleet-wide ``/qos`` (worst-N lobbies across every worker).

Threading: the exporter serves ``/fleet`` and ``/qos`` from HTTP handler
threads while the scheduler's poll loop ingests, so every public method
takes ``self._lock``; metric/timeline emission happens strictly OUTSIDE
the lock (the registry has its own lock, and alert side-effects are
computed as a transition list first).  BGT060 covers this module via
``CONCURRENCY_MODULES`` + ``THREAD_ROOTS`` (scripts/lint/config.py).

See docs/observability.md "Fleet federation & SLOs" for the metric rows
and snapshot schemas."""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from threading import Lock
from typing import Callable, Dict, List, Optional, Tuple

from .. import telemetry

FLEET_SCHEMA = "fleet/v1"
FLEET_QOS_SCHEMA = "fleet-qos/v1"

#: default ring capacity per series — at the 0.25 s heartbeat cadence this
#: holds ~64 s of history per worker, enough for any burn window in use
SERIES_CAPACITY = 256

#: alert history bound (active alerts live in a separate dict)
ALERT_HISTORY = 512


class SeriesRing:
    """Bounded ``(t, value)`` time-series ring with window/rate queries."""

    def __init__(self, capacity: int = SERIES_CAPACITY):
        self._data: deque = deque(maxlen=int(capacity))

    def __len__(self) -> int:
        return len(self._data)

    def add(self, t: float, v: float) -> None:
        """Append one sample (monotonic ``t`` expected, not enforced)."""
        self._data.append((float(t), float(v)))

    def last(self) -> Optional[Tuple[float, float]]:
        """The newest ``(t, value)`` sample, or None when empty."""
        return self._data[-1] if self._data else None

    def window(self, span_s: float,
               now: Optional[float] = None) -> List[Tuple[float, float]]:
        """Samples with ``t >= now - span_s`` (oldest first)."""
        if not self._data:
            return []
        ref = self._data[-1][0] if now is None else now
        lo = ref - span_s
        return [(t, v) for t, v in self._data if t >= lo]

    def rate(self, span_s: float,
             now: Optional[float] = None) -> Optional[float]:
        """Per-second delta over the window (counter-style series); None
        when fewer than two samples span a non-zero interval."""
        win = self.window(span_s, now)
        if len(win) < 2:
            return None
        dt = win[-1][0] - win[0][0]
        if dt <= 0:
            return None
        return (win[-1][1] - win[0][1]) / dt

    def tail(self, n: int) -> List[List[float]]:
        """The newest ``n`` samples as JSON-able ``[t, value]`` pairs."""
        items = list(self._data)[-int(n):]
        return [[t, v] for t, v in items]


@dataclasses.dataclass(frozen=True)
class SLO:
    """One declarative objective evaluated per subject (lobby or worker).

    ``signal`` selects the breach predicate:

    - ``"qos_floor"`` — per-lobby; a sample breaches when the lobby's QoS
      score drops BELOW ``threshold``; the burn-rate test requires at
      least ``burn_fraction`` of the samples inside ``burn_window_s`` to
      breach, continuously for the whole window, before firing.
    - ``"migration_downtime"`` — per-lobby; a migration/failover downtime
      event ABOVE ``threshold`` (ms) breaches; discrete events fire
      immediately (``burn_window_s`` is ignored — one blown ceiling IS
      the incident) and age out of breach after ``resolve_window_s``.
    - ``"heartbeat_liveness"`` — per-worker; breaches while the gap since
      the last accepted heartbeat exceeds ``threshold`` (s); the gap
      itself is the sustain, so fires as soon as it is observed.
    """

    slo_id: str
    signal: str
    threshold: float
    burn_window_s: float = 1.0
    resolve_window_s: float = 1.0
    burn_fraction: float = 1.0
    subject: Optional[str] = None  # pin to one lobby/worker (None = all)


@dataclasses.dataclass(frozen=True)
class AlertEvent:
    """One fire/resolve transition emitted by :meth:`FleetObserver.evaluate`."""

    slo_id: str
    subject: str
    state: str  # "fire" | "resolve"
    t: float
    value: Optional[float]
    threshold: float
    signal: str


def default_slos(*, qos_floor: float = 50.0, qos_burn_window_s: float = 1.0,
                 downtime_ceiling_ms: float = 2000.0,
                 liveness_gap_s: float = 1.5,
                 resolve_window_s: float = 1.0) -> List[SLO]:
    """The stock objective set the scheduler installs when none is given."""
    return [
        SLO("qos_floor", "qos_floor", qos_floor,
            burn_window_s=qos_burn_window_s,
            resolve_window_s=resolve_window_s),
        SLO("migration_downtime", "migration_downtime", downtime_ceiling_ms,
            burn_window_s=0.0, resolve_window_s=resolve_window_s),
        SLO("heartbeat_liveness", "heartbeat_liveness", liveness_gap_s,
            burn_window_s=0.0, resolve_window_s=resolve_window_s),
    ]


class _AlertState:
    """Per-(slo, subject) dedup/hysteresis state."""

    __slots__ = ("active", "breach_since", "clear_since")

    def __init__(self):
        self.active = False
        self.breach_since: Optional[float] = None
        self.clear_since: Optional[float] = None


_WORKER_GAUGES = (
    # (series key, gauge name) — refreshed per accepted full heartbeat
    ("qos_floor", "fleet_worker_qos_floor"),
    ("imbalance", "fleet_worker_imbalance_ratio"),
    ("device_bytes", "fleet_worker_device_resident_bytes"),
    ("assigned_slots", "fleet_worker_assigned_slots"),
    ("heartbeat_gap_ms", "fleet_worker_heartbeat_gap_ms"),
)


class FleetObserver:
    """Scheduler-side federation point: heartbeat time-series, SLO burn
    alerts, and the ``/fleet`` + fleet-wide ``/qos`` snapshot schemas."""

    def __init__(self, slos: Optional[List[SLO]] = None,
                 series_capacity: int = SERIES_CAPACITY,
                 eval_interval_s: float = 0.05):
        self._lock = Lock()
        self._slos: List[SLO] = list(slos) if slos is not None \
            else default_slos()
        self._capacity = int(series_capacity)
        self.eval_interval_s = float(eval_interval_s)
        self._worker_series: Dict[str, Dict[str, SeriesRing]] = {}
        self._lobby_series: Dict[str, Dict[str, SeriesRing]] = {}
        self._lobby_worker: Dict[str, str] = {}
        self._last_hb: Dict[str, float] = {}
        self._astate: Dict[Tuple[str, str], _AlertState] = {}
        self._active: Dict[Tuple[str, str], AlertEvent] = {}
        self._alerts: List[AlertEvent] = []
        self._topology: dict = {}
        self._last_eval = float("-inf")

    # -- ingest ------------------------------------------------------------

    def _series_locked(self, table: Dict[str, Dict[str, SeriesRing]],
                       key: str) -> Dict[str, SeriesRing]:
        d = table.get(key)
        if d is None:
            d = {}
            table[key] = d
        return d

    def _ring_locked(self, d: Dict[str, SeriesRing], key: str) -> SeriesRing:
        r = d.get(key)
        if r is None:
            r = SeriesRing(self._capacity)
            d[key] = r
        return r

    def ingest_heartbeat(self, worker_id: str, stats: dict,
                         now: Optional[float] = None,
                         assigned_slots: Optional[int] = None) -> None:
        """Fold one full heartbeat into the rings + federation gauges."""
        now = time.monotonic() if now is None else now
        stats = stats or {}
        lobbies = stats.get("lobbies") or {}
        qos_map = stats.get("lobby_qos_score") or {}
        qos_floor = float(min(qos_map.values(), default=100.0))
        imbalance = float(stats.get("shard_imbalance_ratio", 1.0))
        dev_bytes = int(stats.get("device_resident_bytes", 0))
        with self._lock:
            prev = self._last_hb.get(worker_id)
            gap_ms = (now - prev) * 1000.0 if prev is not None else 0.0
            self._last_hb[worker_id] = now
            ws = self._series_locked(self._worker_series, worker_id)
            self._ring_locked(ws, "qos_floor").add(now, qos_floor)
            self._ring_locked(ws, "imbalance").add(now, imbalance)
            self._ring_locked(ws, "device_bytes").add(now, dev_bytes)
            if assigned_slots is not None:
                self._ring_locked(ws, "assigned_slots").add(
                    now, int(assigned_slots))
            self._ring_locked(ws, "heartbeat_gap_ms").add(now, gap_ms)
            for lid, st in lobbies.items():
                ls = self._series_locked(self._lobby_series, lid)
                self._ring_locked(ls, "frame").add(
                    now, int(st.get("frame", 0)))
                self._ring_locked(ls, "qos").add(
                    now, float(qos_map.get(lid, 100.0)))
                self._lobby_worker[lid] = worker_id
        # gauge refresh outside the observer lock (registry has its own)
        telemetry.gauge_set("fleet_worker_qos_floor", qos_floor,
                            help="worst reported lobby QoS per worker",
                            worker=worker_id)
        telemetry.gauge_set("fleet_worker_imbalance_ratio", imbalance,
                            help="reported shard_imbalance_ratio per worker",
                            worker=worker_id)
        telemetry.gauge_set("fleet_worker_device_resident_bytes", dev_bytes,
                            help="reported device-resident bytes per worker",
                            worker=worker_id)
        if assigned_slots is not None:
            telemetry.gauge_set("fleet_worker_assigned_slots",
                                int(assigned_slots),
                                help="scheduler-side assigned lobby slots",
                                worker=worker_id)
        telemetry.gauge_set("fleet_worker_heartbeat_gap_ms", gap_ms,
                            help="gap between accepted heartbeats per worker",
                            worker=worker_id)
        for lid in lobbies:
            telemetry.gauge_set("fleet_lobby_qos_score",
                                float(qos_map.get(lid, 100.0)),
                                help="per-lobby QoS score, federated at the "
                                     "scheduler", lobby=lid, worker=worker_id)

    def ingest_liveness(self, worker_id: str,
                        now: Optional[float] = None) -> None:
        """Refresh liveness only (digest-suppressed seq heartbeat)."""
        now = time.monotonic() if now is None else now
        with self._lock:
            prev = self._last_hb.get(worker_id)
            gap_ms = (now - prev) * 1000.0 if prev is not None else 0.0
            self._last_hb[worker_id] = now
            ws = self._series_locked(self._worker_series, worker_id)
            self._ring_locked(ws, "heartbeat_gap_ms").add(now, gap_ms)

    def note_migration(self, lobby_id: str, downtime_ms: float,
                       now: Optional[float] = None) -> None:
        """Record one migration/failover downtime event for ``lobby_id``."""
        now = time.monotonic() if now is None else now
        with self._lock:
            ls = self._series_locked(self._lobby_series, lobby_id)
            self._ring_locked(ls, "downtime_ms").add(now, float(downtime_ms))

    def forget_worker(self, worker_id: str,
                      now: Optional[float] = None) -> List[AlertEvent]:
        """Drop a dead/removed worker; force-resolve its active alerts so
        a failed-over worker does not alert forever."""
        now = time.monotonic() if now is None else now
        emitted: List[AlertEvent] = []
        with self._lock:
            self._last_hb.pop(worker_id, None)
            self._worker_series.pop(worker_id, None)
            for key in [k for k in self._astate if k[1] == worker_id]:
                st = self._astate.pop(key)
                if st.active:
                    prev = self._active.pop(key, None)
                    ev = AlertEvent(
                        slo_id=key[0], subject=worker_id, state="resolve",
                        t=now, value=None,
                        threshold=prev.threshold if prev else 0.0,
                        signal=prev.signal if prev else "")
                    self._alerts.append(ev)
                    emitted.append(ev)
            del self._alerts[:-ALERT_HISTORY]
        self._emit(emitted)
        return emitted

    def set_topology(self, topology: dict) -> None:
        """Install the scheduler's latest workers/lobbies/events view (the
        topology half of the ``/fleet`` snapshot)."""
        with self._lock:
            self._topology = topology or {}

    # -- SLO evaluation ----------------------------------------------------

    def _subjects_locked(self, slo: SLO) -> List[str]:
        if slo.subject is not None:
            return [slo.subject]
        if slo.signal == "heartbeat_liveness":
            return list(self._last_hb)
        key = "downtime_ms" if slo.signal == "migration_downtime" else "qos"
        return [lid for lid, d in self._lobby_series.items() if key in d]

    def _breach_locked(self, slo: SLO, subject: str,
                       now: float) -> Tuple[bool, Optional[float]]:
        """(breaching-now, observed value) for one (slo, subject)."""
        if slo.signal == "heartbeat_liveness":
            last = self._last_hb.get(subject)
            if last is None:
                return False, None
            gap = now - last
            return gap > slo.threshold, round(gap, 6)
        series = self._lobby_series.get(subject, {})
        if slo.signal == "qos_floor":
            ring = series.get("qos")
            win = ring.window(slo.burn_window_s, now) if ring else []
            if not win:
                return False, None
            bad = sum(1 for _, v in win if v < slo.threshold)
            return bad / len(win) >= slo.burn_fraction, win[-1][1]
        if slo.signal == "migration_downtime":
            ring = series.get("downtime_ms")
            win = ring.window(slo.resolve_window_s, now) if ring else []
            bad = [v for _, v in win if v > slo.threshold]
            if bad:
                return True, max(bad)
            return False, (win[-1][1] if win else None)
        return False, None

    def evaluate(self, now: Optional[float] = None) -> List[AlertEvent]:
        """One evaluation tick over every (slo, subject): fire sustained
        breaches, resolve with hysteresis, dedup across ticks.  Returns the
        transitions emitted THIS tick (usually empty)."""
        now = time.monotonic() if now is None else now
        emitted: List[AlertEvent] = []
        with self._lock:
            self._last_eval = now
            for slo in self._slos:
                for subject in self._subjects_locked(slo):
                    key = (slo.slo_id, subject)
                    st = self._astate.get(key)
                    if st is None:
                        st = _AlertState()
                        self._astate[key] = st
                    breaching, value = self._breach_locked(slo, subject, now)
                    if not st.active:
                        if not breaching:
                            st.breach_since = None
                            continue
                        if st.breach_since is None:
                            st.breach_since = now
                        if now - st.breach_since >= slo.burn_window_s:
                            st.active = True
                            st.breach_since = None
                            st.clear_since = None
                            ev = AlertEvent(slo.slo_id, subject, "fire", now,
                                            value, slo.threshold, slo.signal)
                            self._active[key] = ev
                            self._alerts.append(ev)
                            emitted.append(ev)
                    elif breaching:
                        st.clear_since = None
                    else:
                        if st.clear_since is None:
                            st.clear_since = now
                        if now - st.clear_since >= slo.resolve_window_s:
                            st.active = False
                            st.clear_since = None
                            self._active.pop(key, None)
                            ev = AlertEvent(slo.slo_id, subject, "resolve",
                                            now, value, slo.threshold,
                                            slo.signal)
                            self._alerts.append(ev)
                            emitted.append(ev)
            del self._alerts[:-ALERT_HISTORY]
        self._emit(emitted)
        return emitted

    def tick(self, now: Optional[float] = None,
             topology: Optional[Callable[[], dict]] = None
             ) -> List[AlertEvent]:
        """Throttled per-poll hook: refresh topology + evaluate at most
        every ``eval_interval_s`` (the scheduler calls this every poll)."""
        now = time.monotonic() if now is None else now
        with self._lock:
            due = now - self._last_eval >= self.eval_interval_s
        if not due:
            return []
        if topology is not None:
            self.set_topology(topology())
        return self.evaluate(now)

    def _emit(self, events: List[AlertEvent]) -> None:
        """Alert side-effects — strictly outside :attr:`_lock`."""
        for ev in events:
            telemetry.count(
                "fleet_alerts_total",
                help="SLO alert transitions at the fleet scheduler",
                slo=ev.slo_id, state=ev.state,
            )
            telemetry.record(
                "fleet_alert", track="scheduler", slo=ev.slo_id,
                subject=ev.subject, state=ev.state, value=ev.value,
                threshold=ev.threshold,
            )

    # -- read side (HTTP handler threads + CLI) ----------------------------

    def window(self, scope: str, key: str, series: str, span_s: float,
               now: Optional[float] = None) -> List[Tuple[float, float]]:
        """Windowed samples for one series; ``scope`` is ``"worker"`` or
        ``"lobby"`` (the rebalancer-facing query surface)."""
        table = self._worker_series if scope == "worker" \
            else self._lobby_series
        with self._lock:
            ring = table.get(key, {}).get(series)
            return ring.window(span_s, now) if ring else []

    def rate(self, scope: str, key: str, series: str, span_s: float,
             now: Optional[float] = None) -> Optional[float]:
        """Windowed per-second delta for one series (see :meth:`window`)."""
        table = self._worker_series if scope == "worker" \
            else self._lobby_series
        with self._lock:
            ring = table.get(key, {}).get(series)
            return ring.rate(span_s, now) if ring else None

    def active_alerts(self) -> List[dict]:
        """Currently-firing alerts as JSON-able dicts."""
        with self._lock:
            return [dataclasses.asdict(e) for e in self._active.values()]

    def alert_history(self, n: int = ALERT_HISTORY) -> List[dict]:
        """The newest ``n`` fire/resolve transitions, oldest first."""
        with self._lock:
            return [dataclasses.asdict(e) for e in self._alerts[-n:]]

    def fleet_snapshot(self, now: Optional[float] = None,
                       tail: int = 32) -> dict:
        """The ``/fleet`` JSON: topology + per-entity series tails + alerts
        + audit-event tail.  One schema for HTTP and the CLI."""
        now = time.monotonic() if now is None else now
        with self._lock:
            workers: Dict[str, dict] = {}
            topo_workers = self._topology.get("workers") or {}
            for wid, series in self._worker_series.items():
                row = dict(topo_workers.get(wid) or {})
                last = self._last_hb.get(wid)
                row["heartbeat_gap_s"] = (
                    round(now - last, 6) if last is not None else None
                )
                row["series"] = {k: r.tail(tail) for k, r in series.items()}
                workers[wid] = row
            for wid, row in topo_workers.items():
                workers.setdefault(wid, dict(row))
            lobbies: Dict[str, dict] = {}
            topo_lobbies = self._topology.get("lobbies") or {}
            for lid, series in self._lobby_series.items():
                row = dict(topo_lobbies.get(lid) or {})
                row.setdefault("worker", self._lobby_worker.get(lid, ""))
                row["series"] = {k: r.tail(tail) for k, r in series.items()}
                lobbies[lid] = row
            for lid, row in topo_lobbies.items():
                lobbies.setdefault(lid, dict(row))
            return {
                "schema": FLEET_SCHEMA,
                "t": now,
                "workers": workers,
                "lobbies": lobbies,
                "alerts": {
                    "active": [dataclasses.asdict(e)
                               for e in self._active.values()],
                    "recent": [dataclasses.asdict(e)
                               for e in self._alerts[-tail:]],
                },
                "events": list(self._topology.get("events") or [])[-tail:],
            }

    def fleet_qos(self, n: int = 10) -> dict:
        """Fleet-wide worst-N lobbies by latest QoS sample (the fleet-level
        ``/qos`` payload — one scrape ranks every lobby on every worker)."""
        with self._lock:
            rows = []
            for lid, series in self._lobby_series.items():
                ring = series.get("qos")
                last = ring.last() if ring else None
                if last is None:
                    continue
                rows.append({
                    "lobby": lid,
                    "worker": self._lobby_worker.get(lid, ""),
                    "t": last[0],
                    "qos": last[1],
                })
            rows.sort(key=lambda r: (r["qos"], r["lobby"]))
            active = [dataclasses.asdict(e) for e in self._active.values()]
        return {
            "schema": FLEET_QOS_SCHEMA,
            "worst_lobbies": rows[:int(n)],
            "active_alerts": active,
        }


def fleet_routes(observer: FleetObserver,
                 worst_n: int = 10) -> Dict[str, Callable[[], dict]]:
    """Extra JSON routes for the metrics exporter: ``/fleet`` and the
    fleet-wide ``/qos`` override (both served from handler threads)."""
    return {
        "/fleet": observer.fleet_snapshot,
        "/qos": lambda: observer.fleet_qos(worst_n),
    }


def start_fleet_exporter(observer: FleetObserver, port: int = 0,
                         host: str = "127.0.0.1", registry=None,
                         worst_n: int = 10):
    """Start the scheduler's HTTP exporter: federated ``/metrics`` (the
    ``worker=`` labeled gauges live on the default registry) plus
    ``/fleet`` and fleet-wide ``/qos`` from :func:`fleet_routes`."""
    from ..telemetry.prometheus import start_http_exporter

    return start_http_exporter(
        port=port, host=host, registry=registry,
        extra_json_routes=fleet_routes(observer, worst_n),
    )
