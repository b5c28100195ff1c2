"""Per-frame timeline recorder — one ordered event stream per process.

Port of ``bevy_ggrs_tpu/telemetry/timeline.py``.

Merges the three previously separate views of a running session into one
ordered stream: the span ring (``utils/tracing.py`` — SaveWorld / LoadWorld /
AdvanceWorld / HandleRequests phases), per-peer ``network_stats`` snapshots,
and runner decisions (rollback depth, stalls, desyncs).  Each event is a
plain dict ``{"seq", "t", "kind", ...}``; events from different sessions or
lobbies carry a ``session``/``lobby`` field, so exporting one lobby's stream
is a filter over the shared order (the order itself is global — cross-lobby
interleaving is exactly what a batched-server stall investigation needs).

Recording is gated on the package enable flag (near-zero cost disabled) and
bounded by a ring (``maxlen``), mirroring the span ring's memory posture.
Export with :meth:`Timeline.export_jsonl` / :func:`export_jsonl`; the
desync forensics report embeds its tail.
"""

from __future__ import annotations

import json
import time
from collections import deque
from typing import Callable, Deque, List, Optional

from . import metrics as _metrics


class Timeline:
    """Bounded, ordered event recorder (see module docstring)."""

    def __init__(self, maxlen: int = 65536):
        self._events: Deque[dict] = deque(maxlen=maxlen)
        self._seq = 0
        self.dropped = 0  # events evicted past the ring bound

    def record(self, kind: str, **fields) -> None:
        """Append one event (no-op while telemetry is disabled).

        ``fields`` must be JSON-serializable; ``seq`` (process order) and
        ``t`` (perf_counter seconds) are stamped here.  Appending past the
        ring bound evicts the oldest event and counts it in :attr:`dropped`
        (mirrored to the ``timeline_events_dropped_total`` counter and
        ``telemetry.summary()``) — silent truncation would otherwise read
        as "the session only just started" in an export."""
        reg = _metrics._REGISTRY
        if not reg.enabled:
            return
        self._seq += 1
        ev = {"seq": self._seq, "t": time.perf_counter(), "kind": kind}
        ev.update(fields)
        events = self._events
        if len(events) == events.maxlen:
            self.dropped += 1
            reg.counter(
                "timeline_events_dropped_total",
                "timeline events evicted past the ring bound",
            ).inc()
        events.append(ev)

    @property
    def maxlen(self) -> int:
        """The ring bound (events kept)."""
        return self._events.maxlen or 0

    def set_maxlen(self, maxlen: int) -> None:
        """Resize the ring, keeping the newest events that still fit
        (events shed by a shrink count as :attr:`dropped`)."""
        maxlen = int(maxlen)
        if maxlen != self._events.maxlen:
            self.dropped += max(len(self._events) - maxlen, 0)
            self._events = deque(self._events, maxlen=maxlen)

    def events(self, kind: Optional[str] = None, **field_filter) -> List[dict]:
        """Recorded events in order, optionally filtered by kind/fields."""
        out = []
        for ev in list(self._events):
            if kind is not None and ev.get("kind") != kind:
                continue
            if any(ev.get(k) != v for k, v in field_filter.items()):
                continue
            out.append(ev)
        return out

    def tail(self, n: int) -> List[dict]:
        """The last ``n`` events (the forensics-report excerpt)."""
        evs = list(self._events)
        return evs[-n:] if n > 0 else []

    def clear(self) -> None:
        """Drop all events and reset the sequence/dropped counters."""
        self._events.clear()
        self._seq = 0
        self.dropped = 0

    def __len__(self) -> int:
        return len(self._events)

    def export_jsonl(self, path: str, **field_filter) -> int:
        """Write events (optionally filtered) as JSONL; returns the count."""
        evs = self.events(**field_filter)
        with open(path, "w") as f:
            for ev in evs:
                f.write(json.dumps(ev) + "\n")
        return len(evs)


_TIMELINE = Timeline()
_REGISTRY = _metrics._REGISTRY


def timeline() -> Timeline:
    """The process-wide default timeline."""
    return _TIMELINE


def record(kind: str, **fields) -> None:
    """Record one event on the default timeline.  Disabled, this is one
    function call and one flag check: the gate sits here, before the
    method call, because the runners' seams call it per tick."""
    if _REGISTRY.enabled:
        _TIMELINE.record(kind, **fields)


def export_jsonl(path: str, **field_filter) -> int:
    """Export the default timeline as JSONL (see :meth:`Timeline.export_jsonl`)."""
    return _TIMELINE.export_jsonl(path, **field_filter)


def span_sink() -> Callable[[str, float, float], None]:
    """The callback :mod:`..utils.tracing` feeds completed spans through.

    Installing it (done by ``telemetry.enable()``) merges the span ring's
    SaveWorld/LoadWorld/AdvanceWorld/... phases into the timeline as
    ``kind="span"`` events with millisecond durations."""

    def sink(name: str, t0: float, t1: float) -> None:
        _TIMELINE.record("span", name=name, t0=t0, ms=round((t1 - t0) * 1e3, 4))

    return sink
