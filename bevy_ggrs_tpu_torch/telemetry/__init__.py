"""Unified telemetry: metrics registry, per-frame timeline, flight
recorder, phase timers, Chrome trace, device-memory accounting, network
stats, QoS and desync forensics.

Port of ``bevy_ggrs_tpu/telemetry`` with the same public names and the same
serialized formats (Prometheus text, snapshot dicts, JSONL timelines,
forensics reports, Chrome traces), so one dashboard, one
:func:`merge_reports` and one trace viewer read both packages.  The
registry, timeline, flight ring and devmem rows are this package's own
process globals: a JAX runner and a port runner in one process write to
separate registries.  Two modules touch the device: :mod:`.devmem`
(``census`` reads ``torch.cuda.memory_allocated``) and :mod:`.forensics`
(``component_checksums`` takes every component's part from one launch of
the checksum fold kernel).

- :mod:`.metrics` — counters, gauges, labeled histograms;
- :mod:`.timeline` — one ordered event stream per process, JSONL export;
- :mod:`.flight` — the always-on ring of the last ticks' phase breakdowns;
- :mod:`.phases` — guarded per-phase timers of the runners' hot loops;
- :mod:`.forensics` — per-component checksum reports on desync and the
  cross-peer ``merge_reports``;
- :mod:`.netstats` — periodic per-peer NetworkStats/TimeSync sampler
  (``BGT_NETSTATS_EVERY``);
- :mod:`.qos` — lobby health scoring (``/qos``);
- :mod:`.prometheus` — the stdlib ``/metrics``, ``/qos``, ``/trace``
  exporter;
- :mod:`.trace` — Chrome Trace Event export, flows and the N-way merge.

Everything is DISABLED by default and near-free while disabled (one boolean
check per seam); turn it on with :func:`enable` or ``BGT_TELEMETRY=1``.
The flight recorder is on unless ``BGT_FLIGHT_RECORD=0``.  The metric
catalog is the JAX package's (``docs/observability.md``).
"""

from __future__ import annotations

import os

from . import devmem  # noqa: F401 (namespace re-export: telemetry.devmem)
from .flight import (  # noqa: F401 (public re-exports)
    FlightRecorder,
    configure as configure_flight,
    dump_flight_record,
    flight_recorder,
)
from .forensics import (  # noqa: F401
    component_checksums,
    configure as configure_forensics,
    forensics_dir,
    merge_reports,
    write_desync_report,
)
from .metrics import (  # noqa: F401
    FRAME_BUCKETS,
    LATENCY_MS_BUCKETS,
    MS_BUCKETS,
    BoundMetric,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    percentile_from_buckets,
    registry,
)
from .phases import (  # noqa: F401
    PHASES,
    PhaseSet,
    format_phase_table,
    phase_breakdown,
)
from .netstats import NetStatsSampler  # noqa: F401
from .prometheus import MetricsExporter, start_http_exporter  # noqa: F401
from .qos import qos_score, qos_snapshot, update_qos_gauges  # noqa: F401
from .timeline import (  # noqa: F401
    Timeline,
    export_jsonl,
    record,
    span_sink,
    timeline,
)
from .trace import (  # noqa: F401
    chrome_trace,
    flows,
    merge_report_traces,
    merge_traces,
    trace_from_report,
    validate_chrome_trace,
    write_trace,
)

__all__ = [
    "BoundMetric",
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "MetricsExporter",
    "Timeline", "FRAME_BUCKETS", "MS_BUCKETS", "LATENCY_MS_BUCKETS",
    "PHASES", "PhaseSet", "FlightRecorder",
    "phase_breakdown", "format_phase_table",
    "enable", "disable", "enabled", "reset", "summary",
    "registry", "timeline", "record", "export_jsonl", "span_sink",
    "count", "observe", "gauge_set", "percentile_from_buckets",
    "component_checksums", "configure_forensics", "forensics_dir",
    "write_desync_report", "merge_reports", "start_http_exporter",
    "flight_recorder", "configure_flight", "dump_flight_record",
    "NetStatsSampler", "qos_score", "qos_snapshot", "update_qos_gauges",
    "devmem", "chrome_trace", "write_trace", "validate_chrome_trace",
    "trace_from_report", "merge_traces", "merge_report_traces", "flows",
]


def enabled() -> bool:
    """True when telemetry recording is on."""
    return registry().enabled


def enable() -> None:
    """Turn on metrics + timeline recording and hook the span ring in."""
    registry().set_enabled(True)
    from ..utils import tracing

    tracing.set_span_sink(span_sink())


def disable() -> None:
    """Turn recording back off (recorded data stays until :func:`reset`)."""
    registry().set_enabled(False)
    from ..utils import tracing

    tracing.set_span_sink(None)


def reset() -> None:
    """Drop all recorded metrics, timeline events, flight-recorder entries
    and device-memory accounting rows (test isolation)."""
    registry().reset()
    timeline().clear()
    flight_recorder().clear()
    devmem.reset()


def count(name: str, n: float = 1, help: str = "", **labels) -> None:
    """Increment counter ``name`` on the default registry (shorthand)."""
    reg = registry()
    if reg.enabled:
        reg.counter(name, help).inc(n, **labels)


def observe(name: str, v: float, help: str = "", buckets=FRAME_BUCKETS, **labels) -> None:
    """Observe ``v`` on histogram ``name`` on the default registry."""
    reg = registry()
    if reg.enabled:
        reg.histogram(name, help, buckets=buckets).observe(v, **labels)


def gauge_set(name: str, v: float, help: str = "", **labels) -> None:
    """Set gauge ``name`` on the default registry."""
    reg = registry()
    if reg.enabled:
        reg.gauge(name, help).set(v, **labels)


def _latency_percentiles(reg) -> dict:
    """p50/p95/p99 per series of the tick-latency histogram families
    (``tick_phase_ms`` / ``tick_wall_ms`` / ``tick_unattributed_ms``),
    estimated from their cumulative log-spaced buckets.  Keys are the
    series label strings (e.g. ``owner=solo,phase=wave_dispatch``)."""
    out = {}
    for m in reg.metrics():
        if m.kind != "histogram" or m.name not in (
            "tick_phase_ms", "tick_wall_ms", "tick_unattributed_ms",
            "program_compile_ms",
        ):
            continue
        fam = {}
        for key, series in m.series().items():
            skey = ",".join(f"{k}={v}" for k, v in key)
            fam[skey] = {
                f"p{q * 100:g}": round(
                    percentile_from_buckets(m.buckets, series, q), 4
                )
                for q in (0.5, 0.95, 0.99)
            }
            fam[skey]["count"] = series["count"]
        if fam:
            out[m.name] = fam
    return out


def summary() -> dict:
    """One merged dict of everything (the JAX bench's BENCH payload shape).

    Includes derived ratios (``speculation_hit_ratio``) and per-phase
    latency percentiles (``latency_ms`` — p50/p95/p99 per
    ``tick_phase_ms`` series) computed from the raw metrics so consumers
    need no metric arithmetic."""
    reg = registry()
    snap = reg.snapshot()

    def _total(name: str) -> float:
        fam = snap.get(name)
        if not fam:
            return 0.0
        return float(sum(v if not isinstance(v, dict) else v.get("count", 0)
                         for v in fam["series"].values()))

    hits = _total("speculation_hits_total")
    misses = _total("speculation_misses_total")
    return {
        "enabled": reg.enabled,
        "metrics": snap,
        "derived": {
            "speculation_hit_ratio": (
                round(hits / (hits + misses), 4) if hits + misses else None
            ),
            "rollbacks_total": _total("rollbacks_total"),
            "resim_frames_total": _total("resim_frames_total"),
            "checksum_mismatch_total": _total("checksum_mismatch_total"),
            "readback_harvested_total": _total("readback_harvested_total"),
            "readback_forced_total": _total("readback_forced_total"),
            "host_blocked_seconds": _total("host_blocked_seconds"),
            "pipeline_degrade_total": _total("pipeline_degrade_total"),
            "latency_ms": _latency_percentiles(reg),
        },
        "timeline_events": len(timeline()),
        "timeline_events_dropped": timeline().dropped,
        "flight_record_entries": len(flight_recorder()),
        "flight_record_evictions": flight_recorder().evictions,
        # live device-memory residency (always-on registry — see
        # telemetry/devmem.py)
        "device_resident_bytes": devmem.snapshot(),
        "device_resident_total_bytes": devmem.total(),
    }


if os.environ.get("BGT_TELEMETRY", "").strip() in ("1", "true", "on", "yes"):
    enable()
