"""Chrome Trace Event export — the timeline/flight streams as a Perfetto UI.

Port of ``bevy_ggrs_tpu/telemetry/trace.py``, format for format: a trace
of either package loads beside the other and merges with it.

The metrics registry aggregates, the timeline orders, the flight recorder
persists — but none of them *draw*.  This module converts both event
streams into Chrome Trace Event Format JSON (the ``{"traceEvents": [...]}``
shape ui.perfetto.dev and chrome://tracing load directly):

- every flight-recorder ``tick`` entry becomes one ``tick`` slice per
  owner/lobby track with one child slice per phase from the
  :data:`~.phases.PHASES` catalog (phase *durations* are exact; their
  order inside the tick is catalog order — the timers accumulate, they
  don't log interleavings);
- ``rollback`` / ``stall`` / ``checksum_mismatch`` / ``desync_report`` /
  ``forced_readback`` / ``spectator_catchup`` / ``input_send`` events
  become instants;
- per-tick counter tracks: ``rollback_depth``, plus
  ``device_resident_bytes`` (:mod:`.devmem`) and ``pipeline_depth`` when
  the runner stamped them into the tick entry;
- **flow arrows**: every ``rollback`` whose blamed ``(handle, to_frame)``
  matches an ``input_send`` event gets a Chrome flow pair (``ph:"s"`` at
  the send, ``ph:"f"`` at the rollback) — "why did frame N roll back" is
  one arrow in the Perfetto UI.  :func:`merge_traces` extends the pairing
  across two peers' traces (clock-aligned on matching tick frames, the
  ``forensics.merge_reports`` alignment idea applied to traces), so the
  arrow crosses from the blamed peer's send track to the victim's rollback.

Consumers: :func:`write_trace`, the bounded ``/trace`` endpoint on the
Prometheus exporter, and the ``trace_slice`` section of desync forensics
reports.  The event-kind catalog is the JAX package's
(``docs/observability.md``, "Tracing & device memory").
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Tuple

# direct-symbol imports: at package-init time ``telemetry.timeline`` /
# ``telemetry.flight_recorder`` are already rebound to functions, so a
# ``from . import timeline`` here would resolve to the function, not the
# module
from .flight import flight_recorder as _flight_recorder
from .timeline import timeline as _get_timeline

#: timeline kinds converted to instant events (everything else rides args)
_INSTANT_KINDS = (
    "stall", "checksum_mismatch", "desync_report", "spectator_catchup",
    "dispatch", "network_stats", "rollback", "input_send",
    "fleet_wire", "fleet_alert",
)


def _tid_for(ev: dict, tids: Dict[Tuple, int], names: List[dict],
             pid: int) -> int:
    """Stable small-int track id for an event's owner/lobby, registering a
    ``thread_name`` metadata event on first sight."""
    if ev.get("track") is not None:
        # explicit track label: the fleet control plane pins its wire/alert
        # instants to a "scheduler" / "worker:<id>" track
        key = ("track", ev["track"])
        label = str(ev["track"])
    elif ev.get("lobby") is not None:
        key = ("lobby", ev["lobby"])
        label = f"lobby {ev['lobby']}"
    elif ev.get("owner") is not None:
        key = ("owner", ev["owner"])
        label = f"ticks:{ev['owner']}"
    else:
        key = ("main",)
        label = "session"
    tid = tids.get(key)
    if tid is None:
        tid = len(tids)
        tids[key] = tid
        names.append({
            "ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
            "args": {"name": label},
        })
    return tid


def _counter(out: List[dict], pid: int, ts: float, name: str, value) -> None:
    out.append({"ph": "C", "pid": pid, "name": name, "ts": ts,
                "args": {"value": value}})


def chrome_trace(
    timeline_events: Optional[List[dict]] = None,
    flight_entries: Optional[List[dict]] = None,
    *,
    pid: int = 1,
    process_name: str = "bevy_ggrs_tpu",
    max_events: Optional[int] = None,
    metadata: Optional[dict] = None,
) -> dict:
    """Build a Chrome-trace dict from the two event streams.

    Defaults to the process-wide timeline and flight recorder; pass
    explicit lists to convert a forensics report's sections instead.
    ``max_events`` bounds BOTH sources from the tail (the ``/trace``
    endpoint's cap).  Timestamps are microseconds relative to the earliest
    source event.  Always returns a valid trace — empty sources produce
    ``{"traceEvents": [metadata only], ...}``."""
    default_sources = timeline_events is None and flight_entries is None
    if timeline_events is None:
        timeline_events = _get_timeline().events()
    if flight_entries is None:
        flight_entries = _flight_recorder().snapshot()
    if max_events is not None:
        timeline_events = timeline_events[-max_events:]
        flight_entries = flight_entries[-max_events:]

    ts_all = [e["t"] for e in timeline_events if "t" in e]
    ts_all += [e["t"] for e in flight_entries if "t" in e]
    t0 = min(ts_all) if ts_all else 0.0

    def us(t: float) -> float:
        return round((t - t0) * 1e6, 3)

    tids: Dict[Tuple, int] = {}
    meta_events: List[dict] = [{
        "ph": "M", "name": "process_name", "pid": pid,
        "args": {"name": process_name},
    }]
    out: List[dict] = []

    # flight tick entries -> tick slice + phase child slices + counters
    for e in flight_entries:
        kind = e.get("kind")
        if kind == "tick":
            tid = _tid_for(e, tids, meta_events, pid)
            wall_us = float(e.get("wall_ms", 0.0)) * 1e3
            end = us(e["t"])
            start = end - wall_us
            args = {k: e[k] for k in
                    ("frame", "rollbacks", "rollback_depth", "advances",
                     "unattributed_ms", "lobbies") if k in e}
            out.append({"ph": "X", "name": "tick", "ts": round(start, 3),
                        "dur": round(wall_us, 3), "pid": pid, "tid": tid,
                        "args": args})
            cursor = start
            for phase, ms in e.get("phases", {}).items():
                dur = min(ms * 1e3, max(end - cursor, 0.0))
                out.append({"ph": "X", "name": phase,
                            "ts": round(cursor, 3), "dur": round(dur, 3),
                            "pid": pid, "tid": tid, "args": {}})
                cursor += dur
            _counter(out, pid, end, "rollback_depth",
                     e.get("rollback_depth", 0))
            if "device_bytes" in e:
                _counter(out, pid, end, "device_resident_bytes",
                         e["device_bytes"])
            if "pipeline_depth" in e:
                _counter(out, pid, end, "pipeline_depth",
                         e["pipeline_depth"])
        elif kind in ("compile", "forced_readback"):
            tid = _tid_for(e, tids, meta_events, pid)
            args = {k: v for k, v in e.items()
                    if k not in ("seq", "t", "kind", "owner", "lobby")}
            out.append({"ph": "i", "s": "t", "name": kind, "ts": us(e["t"]),
                        "pid": pid, "tid": tid, "args": args})

    # timeline events -> instants (+ "span" slices from the legacy sink)
    have_tl_rollbacks = any(
        e.get("kind") == "rollback" for e in timeline_events
    )
    for e in timeline_events:
        kind = e.get("kind")
        if kind == "span" and "t0" in e:
            tid = _tid_for({"owner": "spans"}, tids, meta_events, pid)
            out.append({"ph": "X", "name": e.get("name", "span"),
                        "ts": us(e["t0"]), "dur": round(e.get("ms", 0) * 1e3, 3),
                        "pid": pid, "tid": tid, "args": {}})
        elif kind in _INSTANT_KINDS:
            tid = _tid_for(e, tids, meta_events, pid)
            args = {k: v for k, v in e.items()
                    if k not in ("seq", "t", "kind", "lobby", "track")}
            out.append({"ph": "i", "s": "t", "name": kind, "ts": us(e["t"]),
                        "pid": pid, "tid": tid, "args": args})
    if not have_tl_rollbacks:
        # telemetry was off: the always-on flight ring still has the
        # attributed rollback entries — surface them so flows can anchor
        for e in flight_entries:
            if e.get("kind") == "rollback":
                tid = _tid_for(e, tids, meta_events, pid)
                args = {k: v for k, v in e.items()
                        if k not in ("seq", "t", "kind", "owner", "lobby")}
                out.append({"ph": "i", "s": "t", "name": "rollback",
                            "ts": us(e["t"]), "pid": pid, "tid": tid,
                            "args": args})

    out.sort(key=lambda ev: ev["ts"])
    events = meta_events + out
    events.extend(_flow_events(events))

    md = {
        "clock": "perf_counter_us",
        "t0_seconds": t0,
        "timeline_events_dropped": (
            _get_timeline().dropped if default_sources else None
        ),
        "flight_record_evictions": (
            _flight_recorder().evictions if default_sources else None
        ),
    }
    if metadata:
        md.update(metadata)
    return {"traceEvents": events, "displayTimeUnit": "ms", "metadata": md}


def _flow_events(events: List[dict],
                 require_cross_pid: bool = False,
                 start_id: int = 1) -> List[dict]:
    """Chrome flow pairs linking each ``rollback`` instant to the
    ``input_send`` instant that caused it.

    A rollback blames ``(handle, to_frame)``; the matching send is the one
    whose sender owns that handle (``handle in args["handles"]``) for that
    frame.  With ``require_cross_pid`` (the merged-trace case) only sends
    from the OTHER peer qualify — a peer never blames its own handle, but
    two merged in-process traces could otherwise double-match."""
    sends = [e for e in events
             if e.get("ph") == "i" and e.get("name") == "input_send"]
    flows: List[dict] = []
    fid = start_id
    for rb in events:
        if rb.get("ph") != "i" or rb.get("name") != "rollback":
            continue
        args = rb.get("args", {})
        handle, frame = args.get("handle"), args.get("to_frame")
        if handle is None or frame is None:
            continue
        for send in sends:
            sa = send.get("args", {})
            if sa.get("frame") != frame or handle not in sa.get("handles", ()):
                continue
            if require_cross_pid and send.get("pid") == rb.get("pid"):
                continue
            common = {"cat": "input_flow", "name": "late_input", "id": fid}
            flows.append({"ph": "s", "ts": send["ts"], "pid": send["pid"],
                          "tid": send["tid"], **common})
            flows.append({"ph": "f", "bp": "e", "ts": rb["ts"],
                          "pid": rb["pid"], "tid": rb["tid"], **common})
            sa["flow_id"] = fid
            args["flow_id"] = fid
            fid += 1
            break
    return flows


def flows(trace: dict) -> List[dict]:
    """The trace's resolved flow arrows as ``{"id", "send", "rollback"}``
    arg dicts — what the flow-correlation tests assert on."""
    by_id: Dict[int, dict] = {}
    for e in trace.get("traceEvents", []):
        if e.get("ph") != "i":
            continue
        fid = e.get("args", {}).get("flow_id")
        if fid is None:
            continue
        side = "send" if e.get("name") == "input_send" else "rollback"
        by_id.setdefault(fid, {"id": fid})[side] = e.get("args", {})
    return [v for _, v in sorted(by_id.items())
            if "send" in v and "rollback" in v]


def write_trace(path: str, **kw) -> int:
    """Serialize :func:`chrome_trace` to ``path``; returns the event count."""
    trace = chrome_trace(**kw)
    with open(path, "w") as f:
        json.dump(trace, f, default=repr)
    return len(trace["traceEvents"])


def trace_from_report(report: dict, *, pid: int = 1,
                      process_name: Optional[str] = None) -> dict:
    """Convert one desync forensics report's ``timeline_tail`` +
    ``flight_record`` sections into a Chrome trace (per-peer input to
    :func:`merge_traces`)."""
    return chrome_trace(
        report.get("timeline_tail") or [],
        report.get("flight_record") or [],
        pid=pid,
        process_name=process_name or f"peer:{report.get('addr') or pid}",
        metadata={"report_kind": report.get("kind"),
                  "timeline_events_dropped": None,
                  "flight_record_evictions": None},
    )


#: (scheduler send op, worker completion op, flow label): the fleet wire
#: pairs the merged view links with flow arrows.  The CKPT -> RESUME_OK
#: "migration" arrow spans exactly the measured migration downtime —
#: barrier-checkpoint-in-hand to restored-on-destination.
_FLEET_FLOW_PAIRS = (
    ("CKPT", "RESUME_OK", "migration"),
    ("PLACE", "PLACE_OK", "place"),
    ("DRAIN", "DRAINED", "drain"),
)

#: worker completion op -> the scheduler send op it answers (clock
#: alignment bounds for traces that share no tick frames)
_WIRE_RESP = {
    "PLACE_OK": "PLACE", "DRAINED": "DRAIN",
    "RESUME_OK": "RESUME", "DROP_RECV": "DROP",
}


def _tick_ts(evs: List[dict]) -> Dict[int, float]:
    """frame -> tick-slice ts (the cross-peer alignment anchors)."""
    return {e["args"]["frame"]: e["ts"] for e in evs
            if e.get("ph") == "X" and e.get("name") == "tick"
            and e.get("args", {}).get("frame") is not None}


def _wire_ts(evs: List[dict]) -> Dict[Tuple, List[float]]:
    """(lid, op) -> sorted ``fleet_wire`` instant timestamps."""
    d: Dict[Tuple, List[float]] = {}
    for e in evs:
        if e.get("ph") != "i" or e.get("name") != "fleet_wire":
            continue
        a = e.get("args", {})
        d.setdefault((a.get("lid"), a.get("op")), []).append(e["ts"])
    return {k: sorted(v) for k, v in d.items()}


def _wire_offset(base: List[dict], new: List[dict]) -> Optional[float]:
    """Clock offset (added to ``new``'s ts) from matched fleet wire
    send/completion pairs — the alignment fallback when the traces share
    no tick frames (a scheduler trace has no tick slices at all).

    A completion happens after its send in real time, so every matched
    pair bounds the offset from one side: a send in ``base`` answered in
    ``new`` gives a lower bound, the mirrored direction an upper bound.
    Taking the tightest bounds makes the estimation error the smallest
    send->completion processing delay among the matched pairs (the DROP ->
    DROP_RECV pair is usually one poll quantum)."""
    ca, cb = _wire_ts(base), _wire_ts(new)
    lowers: List[float] = []  # off >= ts_send(base) - ts_completion(new)
    uppers: List[float] = []  # off <= ts_completion(base) - ts_send(new)
    for (lid, resp_op), resp_ts in cb.items():
        send_ts = ca.get((lid, _WIRE_RESP.get(resp_op)))
        if send_ts:
            lowers.extend(s - r for s, r in zip(send_ts, resp_ts))
    for (lid, resp_op), resp_ts in ca.items():
        send_ts = cb.get((lid, _WIRE_RESP.get(resp_op)))
        if send_ts:
            uppers.extend(r - s for s, r in zip(send_ts, resp_ts))
    if lowers and uppers:
        return (max(lowers) + min(uppers)) / 2.0
    if lowers:
        return max(lowers)
    if uppers:
        return min(uppers)
    return None


def _fleet_flow_events(events: List[dict], start_id: int = 1) -> List[dict]:
    """Cross-pid flow pairs linking scheduler ``fleet_wire`` commands to
    the worker-side completions (:data:`_FLEET_FLOW_PAIRS`), matched by
    lobby id in timestamp order.  Stamps ``flow_id`` into both instants'
    args like :func:`_flow_events` does for input flows."""
    wires = [e for e in events
             if e.get("ph") == "i" and e.get("name") == "fleet_wire"]
    flows: List[dict] = []
    fid = start_id
    for src_op, dst_op, label in _FLEET_FLOW_PAIRS:
        srcs = sorted((e for e in wires
                       if e.get("args", {}).get("op") == src_op),
                      key=lambda e: e["ts"])
        dsts = sorted((e for e in wires
                       if e.get("args", {}).get("op") == dst_op),
                      key=lambda e: e["ts"])
        used = set()
        for s in srcs:
            lid = s.get("args", {}).get("lid")
            for j, d in enumerate(dsts):
                if j in used or d.get("args", {}).get("lid") != lid:
                    continue
                if d.get("pid") == s.get("pid") or d["ts"] < s["ts"]:
                    continue
                common = {"cat": "fleet_flow", "name": label, "id": fid}
                flows.append({"ph": "s", "ts": s["ts"], "pid": s["pid"],
                              "tid": s["tid"], **common})
                flows.append({"ph": "f", "bp": "e", "ts": d["ts"],
                              "pid": d["pid"], "tid": d["tid"], **common})
                s["args"]["flow_id"] = fid
                d["args"]["flow_id"] = fid
                used.add(j)
                fid += 1
                break
    return flows


def merge_traces(trace_a: dict, trace_b: dict, *more: dict) -> dict:
    """Merge N participants' traces into one, clock-aligned and
    flow-correlated (two-peer calls behave exactly as before).

    The FIRST trace is the clock reference; every other trace is shifted
    onto it — for a fleet merge pass the scheduler first, then the
    workers.  Alignment per trace: the median offset over tick slices for
    common frames when the pair shares any (the two-peer desync-forensics
    case), else matched ``fleet_wire`` send/completion pairs
    (:func:`_wire_offset` — workers share wire events with the scheduler,
    never tick frames).  Pids are shifted on collision so each participant
    keeps its own process lane.

    After alignment two flow families are re-paired cross-pid: rollback ->
    ``input_send`` blame arrows (:func:`_flow_events`) and scheduler ->
    worker fleet wire arrows (:func:`_fleet_flow_events`) — the
    ``migration`` arrow spans the measured downtime gap end-to-end."""
    traces = [trace_a, trace_b, *more]
    parts = [[dict(e) for e in t.get("traceEvents", [])] for t in traces]
    for evs in parts:
        for e in evs:
            # drop stale in-process flow stamps: the merged view re-pairs
            # cross-pid only, and flows() must not see the old ids
            a = e.get("args")
            if a and "flow_id" in a:
                e["args"] = {k: v for k, v in a.items() if k != "flow_id"}
    base = parts[0]
    used_pids = {e.get("pid") for e in base if e.get("pid") is not None}
    aligned = 0
    for evs in parts[1:]:
        pids = {e.get("pid") for e in evs if e.get("pid") is not None}
        if pids & used_pids:
            shift = max(used_pids, default=0) + 1
            for e in evs:
                if e.get("pid") is not None:
                    e["pid"] = e["pid"] + shift
            pids = {p + shift for p in pids}
        used_pids |= pids
        ta, tb = _tick_ts(base), _tick_ts(evs)
        common = sorted(set(ta) & set(tb))
        if common:
            offsets = sorted(ta[f] - tb[f] for f in common)
            off = offsets[len(offsets) // 2]
            aligned += len(common)
        else:
            off = _wire_offset(base, evs)
        if off is not None:
            for e in evs:
                if "ts" in e:
                    e["ts"] = round(e["ts"] + off, 3)
    merged = [e for evs in parts for e in evs
              if e.get("ph") != "s" and e.get("ph") != "f"]
    merged.sort(key=lambda ev: (ev.get("ph") != "M", ev.get("ts", 0.0)))
    input_flows = _flow_events(merged, require_cross_pid=True)
    fleet_flows = _fleet_flow_events(
        merged, start_id=1 + len(input_flows) // 2
    )
    merged.extend(input_flows)
    merged.extend(fleet_flows)
    metas = [t.get("metadata", {}) for t in traces]
    md = {
        "merged": True,
        "participants": len(traces),
        "aligned_frames": aligned,
        "a": metas[0],
        "b": metas[1],
        "parts": metas,
    }
    return {"traceEvents": merged, "displayTimeUnit": "ms", "metadata": md}


def merge_report_traces(report_a: dict, report_b: dict) -> dict:
    """Two desync reports -> one merged, flow-correlated Chrome trace
    (the ``replay_tool.py merge-reports --trace-out`` payload)."""
    return merge_traces(
        trace_from_report(report_a, pid=1),
        trace_from_report(report_b, pid=2),
    )


_REQUIRED = {
    "X": ("ts", "dur", "pid", "tid", "name"),
    "i": ("ts", "pid", "tid", "name"),
    "C": ("ts", "pid", "name", "args"),
    "M": ("pid", "name", "args"),
    "s": ("ts", "pid", "tid", "id"),
    "f": ("ts", "pid", "tid", "id"),
}


def validate_chrome_trace(trace) -> List[str]:
    """Structural well-formedness check (the smoke gate): required
    keys per event phase, non-negative durations, ``ts`` monotonic per
    ``(pid, tid)`` track for complete events, and every flow id present as
    a start/finish pair.  Returns a list of problems (empty = valid)."""
    problems: List[str] = []
    if not isinstance(trace, dict) or not isinstance(
        trace.get("traceEvents"), list
    ):
        return ["top level must be a dict with a traceEvents list"]
    last_ts: Dict[Tuple, float] = {}
    flow_phs: Dict[int, set] = {}
    for i, e in enumerate(trace["traceEvents"]):
        if not isinstance(e, dict) or "ph" not in e:
            problems.append(f"event {i}: not a dict with ph")
            continue
        ph = e["ph"]
        for key in _REQUIRED.get(ph, ()):
            if key not in e:
                problems.append(f"event {i} (ph={ph}): missing {key}")
        if ph == "X":
            if e.get("dur", 0) < 0:
                problems.append(f"event {i}: negative dur")
            track = (e.get("pid"), e.get("tid"))
            ts = e.get("ts", 0.0)
            if ts < last_ts.get(track, float("-inf")):
                problems.append(
                    f"event {i}: ts {ts} not monotonic on track {track}"
                )
            last_ts[track] = ts
        elif ph in ("s", "f"):
            flow_phs.setdefault(e.get("id"), set()).add(ph)
    for fid, phs in flow_phs.items():
        if phs != {"s", "f"}:
            problems.append(f"flow id {fid}: unpaired ({sorted(phs)})")
    return problems
