"""Host ms per tick in the session and network layer: the runners' phase
timers ``net_poll`` and ``session_step`` (``telemetry/phases.py``), summed
over the runners, over the whole window."""


def read(rec):
    ph = rec["phase_seconds"]
    s = ph.get("net_poll", 0.0) + ph.get("session_step", 0.0)
    return s / rec["window_ticks"] * 1e3 if rec["window_ticks"] and s > 0 else None
