"""Always-on flight recorder — the last-N-ticks black box.

Port of ``bevy_ggrs_tpu/telemetry/flight.py``.

The metrics registry answers "how often / how much"; the timeline answers
"in what order" — but both are OFF by default, so a production stall or
desync that happens with telemetry disabled leaves nothing to read.  The
flight recorder closes that gap the way an aircraft FDR does: a small
fixed-size ring of the most recent ticks' **phase breakdowns** (per-phase
milliseconds from :mod:`.phases`, wall tick time, the unattributed
residual) plus the runner's frame/rollback decisions and forced-readback
stalls, recorded ALWAYS (unless explicitly disabled) at a cost of one dict
build + deque append per recorded tick.

Consumed two ways:

- dumped into every desync forensics report (:mod:`.forensics`) so the
  report shows what the runner was doing in the ticks leading up to the
  divergence, and
- on demand via :func:`bevy_ggrs_tpu_torch.telemetry.dump_flight_record`
  (or :func:`~.phases.phase_breakdown`, which computes exact per-phase
  percentiles from the ring).

Disable with ``BGT_FLIGHT_RECORD=0`` (or ``configure(enabled=False)``) to
shave the last microsecond off the disabled-telemetry tick path.
"""

from __future__ import annotations

import json
import os
import time
from collections import deque
from typing import Deque, List, Optional

_DEFAULT_MAXLEN = 256


class FlightRecorder:
    """Bounded ring of recent runner events (see module docstring).

    Entries are plain JSON-serializable dicts stamped with a monotonic
    ``seq`` and ``t`` (``perf_counter`` seconds); the ring drops the oldest
    entry past ``maxlen``.  Appends are GIL-atomic (deque), so recording
    from a runner thread while another thread snapshots is safe."""

    def __init__(self, maxlen: int = _DEFAULT_MAXLEN, enabled: bool = True):
        self.enabled = bool(enabled)
        self._ring: Deque[dict] = deque(maxlen=int(maxlen))
        self._seq = 0
        self.evictions = 0  # entries pushed out past the ring bound

    @property
    def maxlen(self) -> int:
        """The ring bound (entries kept)."""
        return self._ring.maxlen or 0

    def set_maxlen(self, maxlen: int) -> None:
        """Resize the ring, keeping the newest entries that still fit
        (entries shed by a shrink count as :attr:`evictions`)."""
        maxlen = int(maxlen)
        if maxlen != self._ring.maxlen:
            self.evictions += max(len(self._ring) - maxlen, 0)
            self._ring = deque(self._ring, maxlen=maxlen)

    def record(self, kind: str, **fields) -> None:
        """Append one event (``kind`` ∈ ``tick`` / ``rollback`` /
        ``compile`` / ``forced_readback`` / ...); no-op when disabled.

        Appending past the ring bound evicts the oldest entry and counts it
        in :attr:`evictions` (surfaced by ``telemetry.summary()`` and trace
        metadata) — a bounded black box must say what it forgot."""
        if not self.enabled:
            return
        self._seq += 1
        ev = {"seq": self._seq, "t": time.perf_counter(), "kind": kind}
        ev.update(fields)
        ring = self._ring
        if len(ring) == ring.maxlen:
            self.evictions += 1
        ring.append(ev)

    def snapshot(self, kind: Optional[str] = None) -> List[dict]:
        """The ring's entries in order (optionally one ``kind`` only)."""
        evs = list(self._ring)
        if kind is not None:
            evs = [ev for ev in evs if ev.get("kind") == kind]
        return evs

    def clear(self) -> None:
        """Drop every entry and reset :attr:`evictions` (the sequence
        counter keeps counting)."""
        self._ring.clear()
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._ring)

    def dump(self, path: str) -> int:
        """Write the ring as one JSON document; returns the entry count."""
        evs = self.snapshot()
        with open(path, "w") as f:
            json.dump(
                {"ts": time.time(), "maxlen": self.maxlen, "events": evs},
                f, indent=2, default=repr,
            )
        return len(evs)


_FLIGHT = FlightRecorder(
    enabled=os.environ.get("BGT_FLIGHT_RECORD", "").strip()
    not in ("0", "false", "off", "no"),
)


def flight_recorder() -> FlightRecorder:
    """The process-wide flight recorder."""
    return _FLIGHT


def configure(
    maxlen: Optional[int] = None, enabled: Optional[bool] = None
) -> FlightRecorder:
    """Adjust the process recorder's ring size and/or on/off switch."""
    if maxlen is not None:
        _FLIGHT.set_maxlen(maxlen)
    if enabled is not None:
        _FLIGHT.enabled = bool(enabled)
    return _FLIGHT


def dump_flight_record(path: str) -> int:
    """Dump the process flight recorder to ``path`` (JSON); entry count."""
    return _FLIGHT.dump(path)
