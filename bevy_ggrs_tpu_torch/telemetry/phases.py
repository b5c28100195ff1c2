"""Tick-phase latency attribution — guarded timers for the runner hot loop.

Port of ``bevy_ggrs_tpu/telemetry/phases.py``; :data:`PHASES` is the JAX
catalog, name for name and in order.

A regression in any single phase of the save→load→advance loop (input
staging, wave dispatch, checksum harvest, rollback load, store/save,
network poll, session stepping) is invisible to event counters until an
aggregate bench gate trips.  This module gives each runner a
:class:`PhaseSet`: a fixed catalog of reusable context-manager timers
(:data:`PHASES`) whose per-tick accumulations feed three sinks at tick end:

- the **flight recorder** (:mod:`.flight`, always on): one ring entry per
  tick with the phase breakdown, wall tick time and the ``unattributed_ms``
  residual — ``sum(phases) + unattributed == wall`` by construction;
- the **metrics registry** (only while telemetry is enabled): one
  ``tick_phase_ms{phase=...,owner=...}`` histogram observation per active
  phase plus ``tick_wall_ms`` / ``tick_unattributed_ms``, all on the
  log-spaced :data:`~.metrics.LATENCY_MS_BUCKETS` so
  ``telemetry.summary()["derived"]`` can report p50/p95/p99 per phase;
- **cumulative totals** on the set itself (:meth:`PhaseSet.totals`) — what
  a bench reconciles against wall time (the ``unattributed_ms <= 10%``
  gate).

Cost discipline: each timer is a preallocated object; entering it is ONE
boolean check when the set is off (flight recorder disabled AND telemetry
disabled), and two ``perf_counter()`` calls plus a float add when on.  No
registry traffic happens inside phases — histogram observes are batched
into ``end_tick``.  A timer measures host time only: no phase synchronizes
the card or reads a tensor, so ``wave_dispatch`` is the host's submission
of the device work, not its execution.
"""

from __future__ import annotations

import time
from typing import Optional

from . import flight as _flight
from .metrics import LATENCY_MS_BUCKETS, _label_key, registry

# The phase catalog — every hot-loop phase of the solo and batched runners
# (the JAX package's, name for name; tests/test_torch_phases.py holds them)
PHASES = (
    "net_poll",          # poll_remote_clients + event drain + net stats
    "session_step",      # session advance_frame (input/ack/checksum protocol)
    "stage_inputs",      # fill the persistent host staging buffers
    "wave_dispatch",     # fused device program submission (+ readback start)
    "readback_harvest",  # collect landed async checksum copies / sync drain
    "rollback_load",     # ring rollback + world restore
    "store_save",        # ring pushes + save-cell publication
)


def _quantile(sorted_vals, q: float) -> float:
    """Linear-interpolated quantile of an already-sorted list."""
    idx = q * (len(sorted_vals) - 1)
    lo = int(idx)
    hi = min(lo + 1, len(sorted_vals) - 1)
    frac = idx - lo
    return sorted_vals[lo] * (1.0 - frac) + sorted_vals[hi] * frac


def phase_breakdown(entries, qs=(0.5, 0.95, 0.99)) -> dict:
    """EXACT per-phase latency percentiles over flight-recorder ``tick``
    entries (the ``--phase-breakdown`` table of the profiling scripts).

    Unlike the registry histograms — which estimate percentiles from
    log-spaced buckets — the flight ring holds each tick's exact
    millisecond values, so a bounded window gets exact quantiles, and it
    works without telemetry ever having been enabled.  Returns
    ``{phase: {"p50": ..., "p95": ..., "p99": ..., "count": n}}`` in
    catalog order plus ``(wall)`` / ``(unattributed)`` rows."""
    series: dict = {}
    for e in entries:
        if e.get("kind") != "tick":
            continue
        for name, ms in e.get("phases", {}).items():
            series.setdefault(name, []).append(ms)
        series.setdefault("(wall)", []).append(e.get("wall_ms", 0.0))
        series.setdefault("(unattributed)", []).append(
            e.get("unattributed_ms", 0.0)
        )
    out = {}
    order = [*PHASES, "(unattributed)", "(wall)"]
    for name in order:
        vals = series.get(name)
        if not vals:
            continue
        vals.sort()
        row = {f"p{q * 100:g}": round(_quantile(vals, q), 4) for q in qs}
        row["count"] = len(vals)
        out[name] = row
    return out


def format_phase_table(breakdown: dict) -> str:
    """Render a :func:`phase_breakdown` dict as the aligned text table the
    profiling scripts print."""
    if not breakdown:
        return "  (no flight-recorder tick entries in the window)"
    qcols = [k for k in next(iter(breakdown.values())) if k != "count"]
    lines = [
        "  " + f"{'phase':18s} {'count':>6} "
        + " ".join(f"{q + ' ms':>10}" for q in qcols)
    ]
    for name, row in breakdown.items():
        lines.append(
            f"  {name:18s} {row['count']:>6} "
            + " ".join(f"{row[q]:>10.3f}" for q in qcols)
        )
    return "\n".join(lines)


class _Phase:
    """One reusable guarded timer: ``with ps.phase("wave_dispatch"): ...``.

    Not reentrant (each catalog phase times a single non-nested region of
    the tick).  When the owning set is off, ``__enter__`` is one boolean
    check and ``__exit__`` one ``is None`` check."""

    __slots__ = ("_ps", "_i", "_t0")

    def __init__(self, ps: "PhaseSet", i: int):
        self._ps = ps
        self._i = i
        self._t0: Optional[float] = None

    def __enter__(self) -> "_Phase":
        if self._ps._on:
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        t0 = self._t0
        if t0 is not None:
            self._ps._acc[self._i] += time.perf_counter() - t0
            self._t0 = None
        return False


class PhaseSet:
    """Per-runner phase accounting: timers, per-tick flush, run totals.

    One instance per runner (``owner`` labels its series: ``"solo"`` /
    ``"batched"``).  The runner calls :meth:`begin_tick` at the top of its
    update, runs phases via ``with self._phases.phase("..."):``, notes
    decisions (:meth:`note_rollback` / :meth:`note_advances`), and calls
    :meth:`end_tick` once per tick that did work."""

    def __init__(self, owner: str = "solo"):
        self.owner = owner
        self._reg = registry()
        self._acc = [0.0] * len(PHASES)
        self._zero = [0.0] * len(PHASES)
        self._timers = {name: _Phase(self, i) for i, name in enumerate(PHASES)}
        self._on = False
        self._t_tick = 0.0
        self._tick_rollbacks = 0
        self._tick_rollback_depth = 0
        self._tick_advances = 0
        # cumulative run totals (always-on; the reconciliation source)
        self.ticks = 0
        self.wall_seconds = 0.0
        self.attributed_seconds = 0.0
        self.unattributed_seconds = 0.0
        self.phase_seconds = {name: 0.0 for name in PHASES}
        # registry handles, re-resolved when the registry generation moves
        self._gen = -1
        self._hist = None
        self._h_wall = None
        self._h_unattr = None
        self._keys = {}
        self._owner_key = ()

    @property
    def on(self) -> bool:
        """Whether this tick is being recorded (set by :meth:`begin_tick`:
        flight recorder OR telemetry enabled).  Runners gate optional
        ``end_tick(**extra)`` computations on it so the fully-disabled tick
        path stays one boolean check."""
        return self._on

    def phase(self, name: str) -> _Phase:
        """The catalog timer for ``name`` (KeyError on a non-catalog name —
        a typo here would silently grow ``unattributed_ms``)."""
        return self._timers[name]

    def begin_tick(self) -> None:
        """Arm the timers for one runner tick (refreshes the on/off gate:
        flight recorder OR telemetry enabled)."""
        self._on = _flight._FLIGHT.enabled or self._reg.enabled
        if self._on:
            # an update that stepped no frame never reaches end_tick: drop
            # what its phases accumulated, or it would land in the next
            # recorded tick with more attributed time than wall time
            self._acc[:] = self._zero
            self._t_tick = time.perf_counter()
            self._tick_rollbacks = 0
            self._tick_rollback_depth = 0
            self._tick_advances = 0

    def note_rollback(self, depth: int) -> None:
        """Count one rollback decision into this tick's flight entry."""
        if self._on:
            self._tick_rollbacks += 1
            if depth > self._tick_rollback_depth:
                self._tick_rollback_depth = depth

    def note_advances(self, n: int) -> None:
        """Count ``n`` advanced frames into this tick's flight entry."""
        if self._on:
            self._tick_advances += n

    def _rebind(self) -> None:
        reg = self._reg
        self._hist = reg.histogram(
            "tick_phase_ms",
            "per-tick milliseconds spent in each hot-loop phase",
            buckets=LATENCY_MS_BUCKETS,
        )
        self._h_wall = reg.histogram(
            "tick_wall_ms", "wall milliseconds per driver tick",
            buckets=LATENCY_MS_BUCKETS,
        )
        self._h_unattr = reg.histogram(
            "tick_unattributed_ms",
            "per-tick wall milliseconds not covered by any phase timer",
            buckets=LATENCY_MS_BUCKETS,
        )
        self._keys = {
            name: _label_key({"phase": name, "owner": self.owner})
            for name in PHASES
        }
        self._owner_key = _label_key({"owner": self.owner})
        self._gen = reg.generation

    def end_tick(self, frame: Optional[int] = None, **extra) -> None:
        """Flush one tick's accumulations: flight entry, histograms,
        cumulative totals.  ``extra`` fields ride into the flight entry
        (e.g. ``lobbies=M`` for the batched runner)."""
        if not self._on:
            return
        wall = time.perf_counter() - self._t_tick
        attributed = 0.0
        phases_ms = {}
        acc = self._acc
        tot = self.phase_seconds
        for i, name in enumerate(PHASES):
            v = acc[i]
            if v:
                attributed += v
                tot[name] += v
                phases_ms[name] = round(v * 1e3, 4)
                acc[i] = 0.0
        unattr = max(wall - attributed, 0.0)
        self.ticks += 1
        self.wall_seconds += wall
        self.attributed_seconds += attributed
        self.unattributed_seconds += unattr
        fr = _flight._FLIGHT
        if fr.enabled:
            fr.record(
                "tick", owner=self.owner, frame=frame,
                wall_ms=round(wall * 1e3, 4), phases=phases_ms,
                unattributed_ms=round(unattr * 1e3, 4),
                rollbacks=self._tick_rollbacks,
                rollback_depth=self._tick_rollback_depth,
                advances=self._tick_advances, **extra,
            )
        reg = self._reg
        if reg.enabled:
            if self._gen != reg.generation:
                self._rebind()
            keys = self._keys
            hist = self._hist
            for name, ms in phases_ms.items():
                hist.observe_key(keys[name], ms)
            self._h_wall.observe_key(self._owner_key, wall * 1e3)
            self._h_unattr.observe_key(self._owner_key, unattr * 1e3)

    def totals(self) -> dict:
        """Cumulative attribution since construction: per-phase seconds,
        wall/attributed/unattributed seconds, tick count, and the
        ``unattributed_pct`` a bench gates on."""
        return {
            "owner": self.owner,
            "ticks": self.ticks,
            "wall_seconds": round(self.wall_seconds, 6),
            "attributed_seconds": round(self.attributed_seconds, 6),
            "unattributed_seconds": round(self.unattributed_seconds, 6),
            "unattributed_pct": round(
                100.0 * self.unattributed_seconds / self.wall_seconds, 2
            ) if self.wall_seconds else 0.0,
            "phase_seconds": {
                k: round(v, 6) for k, v in self.phase_seconds.items() if v
            },
        }
