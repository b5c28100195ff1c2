"""Frame-advantage time synchronisation.

Drives the run-slow flow control: each peer tracks how many frames it is
ahead of each remote (local advantage) and learns the remote's view from
quality reports; ``frames_ahead`` is the smoothed half-difference.  The
runner slows the frame period by x11/10 while positive
(bevy_ggrs src/schedule_systems.rs:34-38,65).

A copy of ``bevy_ggrs_tpu/session/time_sync.py``."""

from __future__ import annotations

from collections import deque
from typing import Deque

WINDOW = 40  # frames of smoothing


class TimeSync:
    """Rolling-window frame-advantage smoothing (drives run-slow).

    Warm-up semantics: before the first quality report lands, the remote
    window is empty.  The old behavior returned 0 from :meth:`frames_ahead`
    until BOTH windows had data — hiding real early-session skew behind a
    value indistinguishable from "perfectly synced".  Now the remote mean
    is seeded at 0 (the first ``note_remote`` replaces the seed), so a
    locally-observed advantage shows through immediately, and
    :meth:`warmed_up` tells "synced" from "no data yet".  Run-slow consumers (``P2PSession.frames_ahead``) gate on
    :meth:`warmed_up` so the scheduler never chases the seed."""
    def __init__(self):
        self.local_adv: Deque[int] = deque(maxlen=WINDOW)
        self.remote_adv: Deque[int] = deque(maxlen=WINDOW)

    def note_local(self, local_frame: int, remote_last_frame: int) -> None:
        self.local_adv.append(local_frame - remote_last_frame)

    def note_remote(self, remote_advantage: int) -> None:
        self.remote_adv.append(remote_advantage)

    def warmed_up(self) -> bool:
        """True once both windows hold at least one real observation —
        i.e. :meth:`frames_ahead` reflects two-sided data, not the zero
        seed standing in for the remote's view."""
        return bool(self.local_adv) and bool(self.remote_adv)

    def local_advantage(self) -> int:
        """Smoothed local frames-ahead of the peer."""
        if not self.local_adv:
            return 0
        return round(sum(self.local_adv) / len(self.local_adv))

    def frames_ahead(self) -> int:
        """Half the smoothed advantage difference: frames we should yield.

        An empty remote window contributes a 0-advantage seed instead of
        suppressing the estimate entirely (see class docstring)."""
        if not self.local_adv:
            return 0
        l = sum(self.local_adv) / len(self.local_adv)
        r = (
            sum(self.remote_adv) / len(self.remote_adv)
            if self.remote_adv
            else 0.0
        )
        return round((l - r) / 2)
