"""Per-peer network-health sampler: NetworkStats + TimeSync -> metrics.

Port of ``bevy_ggrs_tpu/telemetry/netstats.py``.

The runner polls the session's transport every host tick, but scraping
``network_stats()`` for every remote handle at tick rate would cost more
than the data is worth — ping and bandwidth move on quality-report
timescales (hundreds of milliseconds), not frame timescales.  The
:class:`NetStatsSampler` snapshots every remote peer once per ``every``
runner polls (default 60 — once a second at 60 fps) into these families:

- ``peer_ping_ms{handle}`` — round-trip ping histogram
  (``LATENCY_MS_BUCKETS``, so ``percentile_from_buckets`` works on it);
- ``peer_send_queue{handle}`` — pending outbound input packets;
- ``peer_kbps{handle}`` — outbound bandwidth to the peer;
- ``peer_frames_behind{handle,side=local|remote}`` — both sides' frame lag;
- ``frame_advantage{handle}`` — the smoothed per-endpoint
  :meth:`TimeSync.frames_ahead` estimate driving run-slow;
- ``time_sync_warmup{handle}`` — 1 while the peer's TimeSync has not seen
  both sides' advantage data (``frames_ahead`` is one-sided until then);
- ``netstats_samples_total`` — sweeps performed (cadence sanity check).

Cost discipline: ``poll()`` is ONE attribute load + boolean check when the
sampler is disabled (``BGT_NETSTATS_EVERY=0``), an integer increment and
compare between samples, and only touches the registry on the 1-in-``every``
sampling tick — and then only while telemetry is enabled.  Handles whose
:class:`NetworkStats` report ``is_live=False`` (local players, spectators,
disconnected peers) are skipped silently: no logs, no zero-valued series.

The catalog and environment knobs are the JAX package's
(``docs/observability.md``, "Network & QoS").
"""

from __future__ import annotations

import os

from .metrics import LATENCY_MS_BUCKETS, registry

DEFAULT_EVERY = 60  # runner polls between sweeps (~1 s at 60 fps)
ENV_EVERY = "BGT_NETSTATS_EVERY"


def _every_from_env(default: int = DEFAULT_EVERY) -> int:
    """Resolve the sampling cadence from ``BGT_NETSTATS_EVERY``.

    Unset/unparsable values fall back to ``default``; ``0`` (or any
    non-positive value) disables the sampler entirely."""
    raw = os.environ.get(ENV_EVERY, "").strip()
    if not raw:
        return default
    try:
        return int(raw)
    except ValueError:
        return default


class NetStatsSampler:
    """Periodic per-peer NetworkStats/TimeSync sweep (see module docstring).

    Attached by the runner's ``set_session`` to any session exposing
    ``network_stats``; ``poll()`` is called once per host tick inside the
    ``net_poll`` phase."""

    def __init__(self, session, every: int | None = None):
        self.session = session
        self.every = _every_from_env() if every is None else int(every)
        self.enabled = self.every > 0
        self._n = 0
        self.samples = 0

    def poll(self) -> None:
        """Count one runner poll; sweep every ``every``-th call.

        The disabled path is a single boolean check — keep it that way
        (the <1% hot-loop budget)."""
        if not self.enabled:
            return
        self._n += 1
        if self._n < self.every:
            return
        self._n = 0
        if registry().enabled:
            self.sample()

    def _handles(self):
        """Remote player handles of the attached session (empty when the
        session exposes neither the explicit surface nor the addr map)."""
        fn = getattr(self.session, "remote_player_handles", None)
        if fn is not None:
            return fn()
        addr_map = getattr(self.session, "remote_handle_addr", None)
        return sorted(addr_map) if addr_map else []

    def sample(self) -> None:
        """One sweep: snapshot every live remote handle into the per-peer
        metric families.  Non-live handles (``is_live=False``) are skipped
        silently; sessions without per-endpoint TimeSync fall back to the
        session-wide ``frames_ahead`` estimate."""
        s = self.session
        reg = registry()
        ping_h = reg.histogram(
            "peer_ping_ms", "round-trip ping per remote peer",
            buckets=LATENCY_MS_BUCKETS,
        )
        q_g = reg.gauge("peer_send_queue", "pending outbound inputs per peer")
        kbps_g = reg.gauge("peer_kbps", "outbound bandwidth per peer")
        behind_g = reg.gauge(
            "peer_frames_behind",
            "frame lag per peer and side (side=local|remote)",
        )
        adv_g = reg.gauge(
            "frame_advantage",
            "smoothed frames-ahead estimate per peer (run-slow driver)",
        )
        warm_g = reg.gauge(
            "time_sync_warmup",
            "1 while the peer's TimeSync lacks two-sided data",
        )
        time_sync_for = getattr(s, "time_sync_for", None)
        frames_ahead = getattr(s, "frames_ahead", None)
        swept = 0
        for h in self._handles():
            st = s.network_stats(h)
            if not st.is_live:
                continue
            swept += 1
            ping_h.observe(st.ping_ms, handle=h)
            q_g.set(st.send_queue_len, handle=h)
            kbps_g.set(st.kbps_sent, handle=h)
            behind_g.set(st.local_frames_behind, handle=h, side="local")
            behind_g.set(st.remote_frames_behind, handle=h, side="remote")
            ts = time_sync_for(h) if time_sync_for is not None else None
            if ts is not None:
                adv_g.set(ts.frames_ahead(), handle=h)
                warm_g.set(0 if ts.warmed_up() else 1, handle=h)
            elif frames_ahead is not None:
                adv_g.set(frames_ahead(), handle=h)
                warm_g.set(0, handle=h)
        if swept:
            self.samples += 1
            reg.counter(
                "netstats_samples_total", "per-peer NetworkStats sweeps"
            ).inc()
