"""The protocol's virtual clock: a fixed game whatever the host's pace.

The P2P protocol's timers (keep-alives, quality reports, time sync, the
disconnect timeout) read ``now_s`` in ``session/protocol.py`` and
``session/p2p.py``, the wall clock.  On the wall clock a slower host tick
reorders those timers and with them the rollbacks, so the work of a run
would depend on the host's speed.  This clock (a copy of ``TickClock`` in
``chip_smoke.py``) replaces ``now_s`` in both modules and moves one frame,
1/60 s, each time the harness calls :meth:`advance`, once per tick: the
game is then the same tick for tick in every run.  Install it before the
sessions are built, so that their timers start on it.
"""

from __future__ import annotations


class FixedClock:
    """``now_s`` of the port's session modules, moved by :meth:`advance`."""

    START_S = 1000.0

    def __init__(self, fps: int = 60):
        from bevy_ggrs_tpu_torch.session import p2p, protocol

        self._mods = (p2p, protocol)
        self._saved = [m.now_s for m in self._mods]
        self.t = self.START_S
        self._dt = 1.0 / fps
        for m in self._mods:
            m.now_s = self.now

    def now(self) -> float:
        return self.t

    def advance(self) -> None:
        self.t += self._dt

    def close(self) -> None:
        for m, f in zip(self._mods, self._saved):
            m.now_s = f
