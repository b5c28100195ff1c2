"""Lobby quality-of-service scoring: many metric families -> one number.

Port of ``bevy_ggrs_tpu/telemetry/qos.py``.

Dashboards and matchmakers want a single "how healthy is this lobby"
signal, not twelve metric families.  :func:`qos_score` folds the four
dominant degradation axes into one 0..100 gauge:

- **worst-peer ping** — the p95 of ``peer_ping_ms`` for the worst remote
  peer (the slowest link bounds the input-delay budget);
- **rollback rate** — ``rollbacks_total / ticks_total`` (mispredictions
  burn resimulation work and visual stability);
- **forced-readback rate** — ``readback_forced_total`` over all checksum
  readbacks (forced pulls block the host on the device link);
- **tick wall p95** — ``tick_wall_ms`` p95 against the frame budget.

The fold is multiplicative: ``score = 100 * prod(1 / (1 + x_i/scale_i))``,
so the score is **strictly monotone** — worsening any input can only lower
it, improving any input can only raise it (property-tested in
``tests/test_torch_netstats.py``), and a lobby with every axis at its scale
constant lands at ``100 / 2**4``.  No axis can mask another the way a
weighted sum would.

:func:`update_qos_gauges` publishes one ``lobby_qos_score{lobby}`` gauge
per lobby and returns the JSON-able snapshot served by the exporter's
``/qos`` endpoint (:mod:`.prometheus`) and the room server.
"""

from __future__ import annotations

from typing import Dict, Optional

from .metrics import MetricsRegistry, percentile_from_buckets, registry

# Scale constants: the value of each axis that alone halves the score.
PING_SCALE_MS = 120.0  # a transatlantic-grade worst link
ROLLBACK_SCALE = 0.5  # a rollback every other tick
FORCED_SCALE = 0.05  # 5% of checksum readbacks forced (blocking)
TICK_P95_SCALE_MS = 33.3  # two 60fps frame budgets

SCALES = {
    "worst_ping_ms": PING_SCALE_MS,
    "rollback_rate": ROLLBACK_SCALE,
    "forced_readback_rate": FORCED_SCALE,
    "tick_p95_ms": TICK_P95_SCALE_MS,
}


def qos_score(
    worst_ping_ms: float,
    rollback_rate: float,
    forced_readback_rate: float,
    tick_p95_ms: float,
) -> float:
    """Fold the four degradation axes into one 0..100 score.

    Multiplicative and strictly monotone decreasing in every argument
    (negative inputs are clamped to 0 so a bogus sample cannot raise the
    score above the healthy baseline)."""
    score = 100.0
    for value, scale in (
        (worst_ping_ms, PING_SCALE_MS),
        (rollback_rate, ROLLBACK_SCALE),
        (forced_readback_rate, FORCED_SCALE),
        (tick_p95_ms, TICK_P95_SCALE_MS),
    ):
        score *= 1.0 / (1.0 + max(0.0, float(value)) / scale)
    return score


def _counter_total(reg: MetricsRegistry, name: str, lobby=None) -> float:
    """Sum a counter family's series, optionally only those whose ``lobby``
    label matches ``str(lobby)`` (unlabeled series count toward every
    lobby when ``lobby`` is None and toward none otherwise)."""
    total = 0.0
    for m in reg.metrics():
        if m.name != name or m.kind != "counter":
            continue
        for key, val in m.series().items():
            labels = dict(key)
            if lobby is not None and labels.get("lobby") != str(lobby):
                continue
            total += val
    return total


def _histogram_p95_max(reg: MetricsRegistry, name: str) -> float:
    """Worst (max) p95 across every series of histogram family ``name``
    (0.0 when the family is absent or empty)."""
    worst = 0.0
    for m in reg.metrics():
        if m.name != name or m.kind != "histogram":
            continue
        for _key, val in m.series().items():
            p = percentile_from_buckets(m.buckets, val, 0.95)
            if p is not None and p > worst:
                worst = p
    return worst


def _lobby_keys(reg: MetricsRegistry) -> list:
    """Lobby label values seen on ``rollbacks_total`` (the batched runner
    labels per-lobby); ``["default"]`` when none — the solo runner."""
    lobbies = set()
    for m in reg.metrics():
        if m.name != "rollbacks_total":
            continue
        for key, _val in m.series().items():
            lb = dict(key).get("lobby")
            if lb is not None:
                lobbies.add(lb)
    return sorted(lobbies) or ["default"]


def qos_snapshot(reg: Optional[MetricsRegistry] = None) -> dict:
    """Compute the QoS inputs and score for every lobby from the registry.

    Returns the JSON-able ``/qos`` payload::

        {"lobby_qos_score": {lobby: score},
         "lobbies": {lobby: {"score": ..., "inputs": {axis: value}}},
         "scales": {axis: scale}}

    Transport metrics (``peer_ping_ms``) and tick timing are process-wide
    (not lobby-labeled), so they repeat across lobbies; rollback counts use
    the per-lobby series when present."""
    reg = reg or registry()
    worst_ping = _histogram_p95_max(reg, "peer_ping_ms")
    tick_p95 = _histogram_p95_max(reg, "tick_wall_ms")
    ticks = _counter_total(reg, "ticks_total")
    forced = _counter_total(reg, "readback_forced_total")
    harvested = _counter_total(reg, "readback_harvested_total")
    readbacks = forced + harvested
    forced_rate = forced / readbacks if readbacks else 0.0
    lobbies: Dict[str, dict] = {}
    scores: Dict[str, float] = {}
    for lb in _lobby_keys(reg):
        rollbacks = (
            _counter_total(reg, "rollbacks_total")
            if lb == "default"
            else _counter_total(reg, "rollbacks_total", lobby=lb)
        )
        rb_rate = rollbacks / ticks if ticks else 0.0
        inputs = {
            "worst_ping_ms": round(worst_ping, 4),
            "rollback_rate": round(rb_rate, 6),
            "forced_readback_rate": round(forced_rate, 6),
            "tick_p95_ms": round(tick_p95, 4),
        }
        score = round(qos_score(worst_ping, rb_rate, forced_rate, tick_p95), 4)
        lobbies[lb] = {"score": score, "inputs": inputs}
        scores[lb] = score
    return {"lobby_qos_score": scores, "lobbies": lobbies, "scales": dict(SCALES)}


def update_qos_gauges(reg: Optional[MetricsRegistry] = None) -> dict:
    """Publish ``lobby_qos_score{lobby}`` gauges and return the snapshot.

    Gauge writes are no-ops while the registry is disabled; the snapshot is
    computed and returned either way so ``/qos`` always serves data."""
    reg = reg or registry()
    snap = qos_snapshot(reg)
    g = reg.gauge(
        "lobby_qos_score", "folded 0..100 lobby health score (telemetry/qos.py)"
    )
    for lb, score in snap["lobby_qos_score"].items():
        g.set(score, lobby=lb)
    return snap
