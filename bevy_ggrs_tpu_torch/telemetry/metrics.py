"""Process-local metrics registry — counters, gauges, histograms with labels.

Port of ``bevy_ggrs_tpu/telemetry/metrics.py``: the same families, buckets
and Prometheus text, byte for byte.

The unified stat mechanism replacing the ad-hoc integer attributes scattered
across ``runner.py`` / ``batch_runner.py`` / ``session/p2p.py``: every runner
and session counter routes through one :class:`MetricsRegistry` so a single
``snapshot()`` (or Prometheus scrape — see :mod:`.prometheus`) answers "why
did this lobby stall / desync / roll back 7 frames".

Cost model: the registry is DISABLED by default.  Every mutating call
(``inc``/``set``/``observe``) returns after one attribute check when
disabled, so instrumented hot paths (the per-tick runner loop) pay a few ns
per site.  Enable with
:func:`bevy_ggrs_tpu_torch.telemetry.enable` (or ``BGT_TELEMETRY=1``).

Label semantics follow Prometheus: a metric name owns a family of time
series keyed by sorted ``(label, value)`` pairs.  Histograms use fixed
upper-bound buckets (cumulative on export, like Prometheus ``le``).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple

# default histogram buckets, tuned for the two native unit families:
# frames (rollback depth, input latency — small ints) and milliseconds
FRAME_BUCKETS = (0.0, 1.0, 2.0, 3.0, 4.0, 6.0, 8.0, 12.0, 16.0, 32.0)
MS_BUCKETS = (0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0)
# fixed log-spaced latency buckets (1-2-5 per decade, 5us .. 1s) — the
# tick-phase timers' family: wide enough that one set covers a sub-ms CPU
# staging phase and a 100ms+ cold-compile dispatch without re-bucketing
LATENCY_MS_BUCKETS = (
    0.005, 0.01, 0.02, 0.05, 0.1, 0.2, 0.5,
    1.0, 2.0, 5.0, 10.0, 20.0, 50.0, 100.0, 200.0, 500.0, 1000.0,
)

LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, object]) -> LabelKey:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


class _Metric:
    """Common base: name, help text, per-label-set series storage."""

    kind = "untyped"

    def __init__(self, registry: "MetricsRegistry", name: str, help: str = ""):
        self._reg = registry
        self.name = name
        self.help = help
        self._series: Dict[LabelKey, object] = {}

    def series(self) -> Dict[LabelKey, object]:
        """Raw per-label-set values (shallow copy, lock-protected)."""
        with self._reg._lock:
            return dict(self._series)


class Counter(_Metric):
    """Monotonically increasing value (e.g. ``rollbacks_total``)."""

    kind = "counter"

    def inc(self, n: float = 1, **labels) -> None:
        """Add ``n`` (default 1) to the series selected by ``labels``."""
        if not self._reg.enabled:
            return
        key = _label_key(labels)
        with self._reg._lock:
            self._series[key] = self._series.get(key, 0) + n

    def value(self, **labels) -> float:
        """Current value of one series (0 if never incremented)."""
        return self._series.get(_label_key(labels), 0)


class Gauge(_Metric):
    """Point-in-time value that can go up or down (e.g. ``ping_ms``)."""

    kind = "gauge"

    def set(self, v: float, **labels) -> None:
        """Set the series selected by ``labels`` to ``v``."""
        if not self._reg.enabled:
            return
        with self._reg._lock:
            self._series[_label_key(labels)] = v

    def set_key(self, key: LabelKey, v: float) -> None:
        """Set by precomputed label key — hot-path variant (the
        ``Histogram.observe_key`` analog) for callers that cache the key."""
        if not self._reg.enabled:
            return
        with self._reg._lock:
            self._series[key] = v

    def inc(self, n: float = 1, **labels) -> None:
        """Add ``n`` to the gauge (down with negative ``n``)."""
        if not self._reg.enabled:
            return
        key = _label_key(labels)
        with self._reg._lock:
            self._series[key] = self._series.get(key, 0) + n

    def value(self, **labels) -> float:
        """Current value of one series (0 if never set)."""
        return self._series.get(_label_key(labels), 0)


class Histogram(_Metric):
    """Fixed-bucket distribution (e.g. ``rollback_depth`` in frames).

    Each series stores per-bucket counts plus ``sum``/``count``; export
    renders cumulative Prometheus ``le`` buckets."""

    kind = "histogram"

    def __init__(self, registry, name, help="", buckets: Sequence[float] = FRAME_BUCKETS):
        super().__init__(registry, name, help)
        self.buckets: Tuple[float, ...] = tuple(sorted(buckets))

    def observe(self, v: float, **labels) -> None:
        """Record one observation of ``v``."""
        if not self._reg.enabled:
            return
        self.observe_key(_label_key(labels), v)

    def observe_key(self, key: LabelKey, v: float) -> None:
        """Observe with a pre-resolved label key — the hot-path variant:
        callers that observe the same series every tick (the phase timers)
        build the key once instead of sorting a label dict per call."""
        if not self._reg.enabled:
            return
        with self._reg._lock:
            s = self._series.get(key)
            if s is None:
                s = {"buckets": [0] * len(self.buckets), "sum": 0.0, "count": 0}
                self._series[key] = s
            for i, ub in enumerate(self.buckets):
                if v <= ub:
                    s["buckets"][i] += 1
                    break
            s["sum"] += v
            s["count"] += 1

    def snapshot(self, **labels) -> Optional[dict]:
        """One series as ``{"buckets", "sum", "count"}`` (or None)."""
        s = self._series.get(_label_key(labels))
        if s is None:
            return None
        return {"buckets": list(s["buckets"]), "sum": s["sum"], "count": s["count"]}

    def percentile(self, q: float, **labels) -> Optional[float]:
        """Estimate the ``q``-quantile (0 < q <= 1) of one series from its
        cumulative bucket counts — linear interpolation inside the covering
        bucket (the ``histogram_quantile`` estimator).  Observations past the
        last finite bound clamp to it, exactly like Prometheus; returns None
        for an empty/absent series."""
        s = self.snapshot(**labels)
        return percentile_from_buckets(self.buckets, s, q) if s else None

    def percentiles(self, qs=(0.5, 0.95, 0.99), **labels) -> Optional[dict]:
        """``{"p50": ..., "p95": ..., "p99": ...}`` for one series (one
        snapshot, N estimates), or None for an empty/absent series."""
        s = self.snapshot(**labels)
        if not s or not s["count"]:
            return None
        return {
            f"p{q * 100:g}": percentile_from_buckets(self.buckets, s, q)
            for q in qs
        }


class MetricsRegistry:
    """Get-or-create metric families; snapshot/export the lot.

    One instance per process is the intended shape (:func:`registry`); tests
    may build private registries.  ``enabled`` gates every mutation — flip it
    with :meth:`set_enabled` (the package-level ``enable()``/``disable()``
    forward here)."""

    def __init__(self, enabled: bool = False):
        self.enabled = enabled
        self._metrics: Dict[str, _Metric] = {}
        self._lock = threading.Lock()
        # bumped on every reset() so BoundMetric handles held by hot loops
        # know their cached family object is stale
        self.generation = 0

    def set_enabled(self, enabled: bool) -> None:
        """Enable/disable all mutation on this registry's metrics."""
        self.enabled = bool(enabled)

    def _get_or_create(self, cls, name: str, help: str, **kw) -> _Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(self, name, help, **kw)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as {m.kind}, "
                    f"requested {cls.kind}"
                )
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        """Get or create a :class:`Counter` named ``name``."""
        return self._get_or_create(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        """Get or create a :class:`Gauge` named ``name``."""
        return self._get_or_create(Gauge, name, help)

    def histogram(
        self, name: str, help: str = "", buckets: Sequence[float] = FRAME_BUCKETS
    ) -> Histogram:
        """Get or create a :class:`Histogram` named ``name``."""
        return self._get_or_create(Histogram, name, help, buckets=buckets)

    def metrics(self) -> List[_Metric]:
        """All registered metric families, name-sorted."""
        with self._lock:
            return [self._metrics[k] for k in sorted(self._metrics)]

    def snapshot(self) -> dict:
        """Plain-dict dump: ``{name: {"kind", "help", "series": {...}}}``.

        Series keys are rendered as ``label=value,label=value`` strings
        ("" for the unlabeled series) so the result is JSON-serializable —
        the JSON-serializable dict a bench merges into its output."""
        out = {}
        for m in self.metrics():
            series = {}
            for key, val in m.series().items():
                skey = ",".join(f"{k}={v}" for k, v in key)
                if isinstance(val, dict):  # histogram series
                    series[skey] = {
                        "sum": val["sum"],
                        "count": val["count"],
                        "buckets": dict(
                            zip([str(b) for b in m.buckets], val["buckets"])
                        ),
                    }
                else:
                    series[skey] = val
            out[m.name] = {"kind": m.kind, "help": m.help, "series": series}
        return out

    def reset(self) -> None:
        """Drop every metric family (test isolation).

        Bumps :attr:`generation` so :class:`BoundMetric` handles held by hot
        loops re-resolve their family on the next call instead of mutating an
        orphaned object."""
        with self._lock:
            self._metrics.clear()
            self.generation += 1

    def bind_counter(self, name: str, help: str = "") -> "BoundMetric":
        """Pre-bound counter handle for hot loops (see :class:`BoundMetric`)."""
        return BoundMetric(self, "counter", name, help)

    def bind_gauge(self, name: str, help: str = "") -> "BoundMetric":
        """Pre-bound gauge handle for hot loops."""
        return BoundMetric(self, "gauge", name, help)

    def bind_histogram(
        self, name: str, help: str = "", buckets: Sequence[float] = FRAME_BUCKETS
    ) -> "BoundMetric":
        """Pre-bound histogram handle for hot loops."""
        return BoundMetric(self, "histogram", name, help, buckets=buckets)

    def render_prometheus(self) -> str:
        """Prometheus text exposition format (version 0.0.4) of everything."""
        lines: List[str] = []
        for m in self.metrics():
            if m.help:
                lines.append(f"# HELP {m.name} {_escape_help(m.help)}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            for key, val in sorted(m.series().items()):
                if isinstance(val, dict):  # histogram
                    cum = 0
                    for ub, n in zip(m.buckets, val["buckets"]):
                        cum += n
                        lines.append(
                            f"{m.name}_bucket{_fmt_labels(key, le=_fmt_float(ub))} {cum}"
                        )
                    lines.append(
                        f'{m.name}_bucket{_fmt_labels(key, le="+Inf")} {val["count"]}'
                    )
                    lines.append(f"{m.name}_sum{_fmt_labels(key)} {_fmt_float(val['sum'])}")
                    lines.append(f"{m.name}_count{_fmt_labels(key)} {val['count']}")
                else:
                    lines.append(f"{m.name}{_fmt_labels(key)} {_fmt_float(val)}")
        return "\n".join(lines) + "\n"


def percentile_from_buckets(buckets, series: dict, q: float) -> Optional[float]:
    """The quantile estimator shared by :meth:`Histogram.percentile` and
    offline consumers (``telemetry.summary()``, ``--phase-breakdown``):
    walk the fixed ``buckets`` against one series' per-bucket counts, then
    interpolate linearly inside the bucket covering rank ``q * count``.
    Observations above the last finite bound clamp to it (the Prometheus
    ``histogram_quantile`` convention)."""
    count = series.get("count", 0)
    if not count:
        return None
    target = q * count
    cum = 0
    lo = 0.0
    for ub, n in zip(buckets, series["buckets"]):
        if n:
            if cum + n >= target:
                return lo + (ub - lo) * (target - cum) / n
            cum += n
        lo = ub
    return float(buckets[-1])  # overflow (+Inf) bucket: clamp


def _fmt_float(v) -> str:
    """Render a number the way Prometheus text format expects."""
    if isinstance(v, float) and v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return str(v)


def _escape_label_value(v: str) -> str:
    """Label-value escaping per text format 0.0.4: backslash, double-quote
    and line feed must be escaped or a scrape with e.g. a peer address of
    ``"\\n"`` in a label silently corrupts the whole exposition."""
    return v.replace("\\", r"\\").replace('"', r"\"").replace("\n", r"\n")


def _escape_help(v: str) -> str:
    """HELP-text escaping per text format 0.0.4 (backslash and line feed)."""
    return v.replace("\\", r"\\").replace("\n", r"\n")


def _fmt_labels(key: LabelKey, **extra) -> str:
    parts = [f'{k}="{_escape_label_value(v)}"' for k, v in key] + [
        f'{k}="{_escape_label_value(str(v))}"' for k, v in extra.items()
    ]
    return "{" + ",".join(parts) + "}" if parts else ""


class BoundMetric:
    """Resolve-once handle to a metric family for per-tick hot paths.

    The ad-hoc ``telemetry.count(name, n, help=...)`` convenience re-passes the
    name and help string on every call, which in the runner loop means a dict
    lookup plus string traffic per tick per metric.  A ``BoundMetric`` does the
    name/help registration exactly once (at construction) and afterwards its
    :meth:`inc`/:meth:`set`/:meth:`observe` are a couple of attribute checks
    plus the underlying metric mutation.  The handle watches the registry's
    ``generation`` counter so a ``reset()`` (test isolation) transparently
    re-creates the family rather than mutating an orphan that no snapshot
    will ever see.
    """

    __slots__ = ("_reg", "_kind", "_name", "_help", "_kw", "_gen", "_m")

    def __init__(self, reg: MetricsRegistry, kind: str, name: str, help: str, **kw):
        self._reg = reg
        self._kind = kind
        self._name = name
        self._help = help
        self._kw = kw
        self._gen = -1
        self._m: Optional[_Metric] = None
        self._resolve()

    def _resolve(self) -> _Metric:
        if self._kind == "counter":
            self._m = self._reg.counter(self._name, self._help)
        elif self._kind == "gauge":
            self._m = self._reg.gauge(self._name, self._help)
        else:
            self._m = self._reg.histogram(self._name, self._help, **self._kw)
        self._gen = self._reg.generation
        return self._m

    def _metric(self) -> _Metric:
        m = self._m
        if self._gen != self._reg.generation:
            m = self._resolve()
        return m

    def inc(self, n: float = 1) -> None:
        """Counter/gauge increment by ``n`` (no labels — that's the point)."""
        if not self._reg.enabled:
            return
        self._metric().inc(n)

    def set(self, v: float) -> None:
        """Gauge set."""
        if not self._reg.enabled:
            return
        self._metric().set(v)

    def observe(self, v: float) -> None:
        """Histogram observation."""
        if not self._reg.enabled:
            return
        self._metric().observe(v)

    def value(self) -> float:
        """Current unlabeled value (0 if the family was reset away)."""
        return self._metric().value()


_REGISTRY = MetricsRegistry()


def registry() -> MetricsRegistry:
    """The process-wide default registry."""
    return _REGISTRY
