"""Desync forensics — per-component checksum dumps on checksum mismatch.

Port of ``bevy_ggrs_tpu/telemetry/forensics.py``: the report's JSON schema
and :func:`merge_reports` are the JAX package's, so a JAX peer's report and
a port peer's merge.  :func:`component_checksums` runs on the port's
checksum: every checksummed component's part for both seeds from ONE launch
of the checksum fold kernel (``ops/checksum_fold.py``), where the JAX
package runs one pass per component and seed.

A 64-bit world checksum says two peers diverged; it cannot say WHERE.  This
module decomposes the divergence: on a SyncTest mismatch or a P2P
``DesyncDetected`` event the runner calls :func:`write_desync_report`, which
hashes every registered component/resource SEPARATELY (the same per-type
parts ``snapshot/checksum.py`` XORs into the world checksum), attaches the
last N timeline events plus the full metrics snapshot, and writes one JSON
report file.  Diffing two peers' reports names the diverged component
directly (the JAX package's ``docs/debugging-desyncs.md`` §6 has the
workflow).

Reports are written only when a directory is configured
(:func:`configure` or ``BGT_FORENSICS_DIR``); the hooks are otherwise free.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional

from . import flight as _flight
from . import metrics as _metrics
from . import timeline as _timeline

_STATE = {
    "dir": os.environ.get("BGT_FORENSICS_DIR") or None,
    "timeline_tail": 200,
}


def configure(dir: Optional[str] = None, timeline_tail: Optional[int] = None) -> None:
    """Set the report directory (None disables) and timeline excerpt length."""
    _STATE["dir"] = dir
    if timeline_tail is not None:
        _STATE["timeline_tail"] = int(timeline_tail)


def forensics_dir() -> Optional[str]:
    """The configured report directory, or None when reporting is off."""
    return _STATE["dir"]


def component_checksums(reg, world) -> dict:
    """Per-part 64-bit checksums of ``world``: one per checksummed component
    and resource, plus the entity part — all read back in ONE copy.

    Keys are component names, ``res:<name>`` for resources and
    ``__entities__``; values are ints comparable across peers (and across
    the two packages) exactly like the combined world checksum.

    Device work: one fold launch gives every checksummed component's hi and
    lo part (``component_parts`` over the world stacked to ``k = 1`` with
    both seeds), one fold with no components the entity part, and each
    resource its torch ops; the parts are concatenated on the device and
    copied to the host once.  This is the one telemetry seam that reads the
    card, and it runs only after a detected desync: the world may still be
    in flight in a pipelined runner, so the read waits for the current
    stream's work first (the resim that made the world ran there)."""
    import torch

    from ..snapshot.checksum import (
        SEEDS,
        _resource_parts,
        _stack1,
        component_parts,
    )

    stacked = _stack1(world)
    names = [n for n, spec in reg.components.items() if spec.checksum]
    res_names = [n for n, spec in reg.resources.items() if spec.checksum]
    rows = []
    if names:
        rows.append(component_parts(reg, stacked, names, SEEDS)[0])  # [C, 2]
    for name in res_names:
        rows.append(torch.stack(
            [_resource_parts(reg, stacked, name, seed)[0] for seed in SEEDS])[None])
    rows.append(_entity_parts(stacked)[None])
    parts = torch.cat(rows)
    if parts.device.type == "cuda":
        torch.cuda.current_stream(parts.device).synchronize()
    host = parts.cpu().tolist()
    keys = names + ["res:" + n for n in res_names] + ["__entities__"]
    # sorted by name, as the JAX package's one device_get of a dict is
    return {key: (int(hi) << 32) | int(lo) for key, (hi, lo) in sorted(zip(keys, host))}


def _entity_parts(stacked):
    """The entity part of a ``k = 1`` stack for both seeds, ``[2]``: one
    fold with no components (its checksum column is the entity part
    alone)."""
    from ..ops.checksum_fold import checksum_fold
    from ..snapshot.checksum import SEEDS, fold_inputs

    return checksum_fold(*fold_inputs(None, stacked, [], SEEDS))[0, 0]


def write_desync_report(
    kind: str,
    reg=None,
    world=None,
    frames=None,
    local_checksum: Optional[int] = None,
    remote_checksum: Optional[int] = None,
    addr=None,
    lobby: Optional[int] = None,
    path: Optional[str] = None,
    checksums: Optional[dict] = None,
) -> Optional[str]:
    """Dump a desync forensics report; returns the file path (or None when
    no directory is configured and no explicit ``path`` given).

    ``kind`` is ``"synctest_mismatch"`` or ``"p2p_desync"``; ``reg``/``world``
    (when available) produce the per-component checksum section.
    ``checksums`` is the per-frame ``{frame: world_checksum}`` map the
    session still holds — the alignment key :func:`merge_reports` uses to
    find the first divergent frame across two peers' reports."""
    if path is None:
        d = _STATE["dir"]
        if d is None:
            return None
        os.makedirs(d, exist_ok=True)
        path = os.path.join(
            d, f"desync_{kind}_{int(time.time() * 1e3)}_{os.getpid()}.json"
        )
    report = {
        "kind": kind,
        "ts": time.time(),
        "frames": list(frames) if frames is not None else None,
        "local_checksum": local_checksum,
        "remote_checksum": remote_checksum,
        "addr": repr(addr) if addr is not None else None,
        "lobby": lobby,
        "checksums": (
            {int(f): v for f, v in checksums.items()}
            if checksums is not None
            else None
        ),
        "component_checksums": (
            component_checksums(reg, world)
            if reg is not None and world is not None
            else None
        ),
        "timeline_tail": _timeline.timeline().tail(_STATE["timeline_tail"]),
        # always-on black box: the last-N-ticks phase breakdowns and
        # rollback decisions are present even when telemetry was never
        # enabled
        "flight_record": _flight.flight_recorder().snapshot(),
        "metrics": _metrics.registry().snapshot(),
    }
    # Perfetto-loadable excerpt of the same window: extract with jq
    # '.trace_slice', or merge both peers' reports with
    # trace.merge_report_traces for the cross-peer flow-arrow view
    from .trace import chrome_trace

    report["trace_slice"] = chrome_trace(
        report["timeline_tail"], report["flight_record"],
        metadata={"report_kind": kind},
    )
    with open(path, "w") as f:
        json.dump(report, f, indent=2, default=repr)
    reg_ = _metrics.registry()
    if reg_.enabled:
        reg_.counter(
            "desync_reports_total", "forensics reports written"
        ).inc(kind=kind)
    _timeline.record("desync_report", report_kind=kind, path=path)
    return path


def _frame_checksums(report: dict) -> dict:
    """The report's per-frame checksum map with int frame keys (JSON
    round-trips dict keys as strings)."""
    out = {}
    for k, v in (report.get("checksums") or {}).items():
        try:
            out[int(k)] = v
        except (TypeError, ValueError):
            continue
    return out


def _flight_entries(report: dict, kind: str) -> list:
    """Entries of one kind from the report's flight-record section."""
    return [
        e
        for e in (report.get("flight_record") or [])
        if isinstance(e, dict) and e.get("kind") == kind
    ]


def merge_reports(path_a: str, path_b: str) -> dict:
    """Cross-peer forensics merge: align two peers' desync reports by frame
    and localize the divergence.

    Frame-aligns both reports' per-frame checksum maps, finds the first
    frame where both peers recorded a value and the values differ, diffs the
    per-component checksum sections, and pulls each side's flight-recorder
    context (tick entries around the divergent frame, every rollback
    decision with its blamed handle).  Returns::

        {"first_divergent_frame": int | None,
         "common_frames": n, "divergent_frames": [f, ...],
         "checksums_at_divergence": {"a": ..., "b": ...},
         "component_diff": [name, ...] | None,
         "rollbacks": {"a": [...], "b": [...]},
         "tick_context": {"a": [...], "b": [...]}}

    ``first_divergent_frame`` is None when the overlapping frames agree —
    the divergence happened outside the retained checksum window (rerun
    with a denser desync-detection interval; see
    ``docs/debugging-desyncs.md`` §0)."""
    with open(path_a) as f:
        a = json.load(f)
    with open(path_b) as f:
        b = json.load(f)
    cs_a, cs_b = _frame_checksums(a), _frame_checksums(b)
    common = sorted(set(cs_a) & set(cs_b))
    divergent = [f for f in common if cs_a[f] != cs_b[f]]
    first = divergent[0] if divergent else None
    if first is None:
        # no overlapping per-frame data disagreed; fall back to the frames
        # the detectors themselves flagged (present in both reports)
        flagged = sorted(
            set(a.get("frames") or []) & set(b.get("frames") or [])
        )
        first = flagged[0] if flagged else None
    comp_diff = None
    ca, cb = a.get("component_checksums"), b.get("component_checksums")
    if ca and cb:
        comp_diff = sorted(
            name
            for name in set(ca) | set(cb)
            if ca.get(name) != cb.get(name)
        )

    def _context(rep: dict) -> list:
        if first is None:
            return _flight_entries(rep, "tick")[-8:]
        return [
            e
            for e in _flight_entries(rep, "tick")
            if e.get("frame") is not None and abs(e["frame"] - first) <= 4
        ]

    return {
        "a": path_a,
        "b": path_b,
        "first_divergent_frame": first,
        "common_frames": len(common),
        "divergent_frames": divergent,
        "checksums_at_divergence": (
            {"a": cs_a.get(first), "b": cs_b.get(first)}
            if first is not None
            else None
        ),
        "component_diff": comp_diff,
        "rollbacks": {
            "a": _flight_entries(a, "rollback"),
            "b": _flight_entries(b, "rollback"),
        },
        "tick_context": {"a": _context(a), "b": _context(b)},
    }
