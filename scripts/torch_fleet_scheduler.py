#!/usr/bin/env python
"""Fleet scheduler daemon of the PyTorch port: matchmaking, placement,
migration, failover.

    python scripts/torch_fleet_scheduler.py --port 3600 --metrics-port 9464

Workers (``scripts/torch_fleet_worker.py``, or the JAX package's
``scripts/fleet_worker.py``: the wire is the same) register against the
port; clients submit lobbies with SUBMIT datagrams
(``bevy_ggrs_tpu_torch.fleet.FleetClient``).  The 5 s reporting loop prints
the federated ``/fleet`` snapshot (the schema the HTTP endpoint serves);
with ``--metrics-port`` the registry is scrapable as Prometheus text plus
the ``/fleet`` and ``/qos`` JSON routes.  ``--status URL`` is a one-shot
client mode: fetch a running scheduler's ``/fleet`` JSON, pretty-print it,
exit.  The flags are ``scripts/fleet_scheduler.py``'s.

The scheduler holds no device: admission sizes lobbies on the CPU, so it
runs on any host, with or without a card (``--device`` and ``BGT_PLATFORM``
are the workers' concern)."""

import argparse
import json
import sys
import time
import urllib.request
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from bevy_ggrs_tpu_torch import telemetry  # noqa: E402
from bevy_ggrs_tpu_torch.fleet import FleetScheduler, start_fleet_exporter  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--port", type=int, default=3600)
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--worker-timeout", type=float, default=2.0,
                    help="heartbeat silence before a worker is declared "
                         "dead and its lobbies failed over (s)")
    ap.add_argument("--mem-budget-mb", type=int, default=512,
                    help="per-worker device-bytes admission budget")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="serve Prometheus /metrics on this port")
    ap.add_argument("--metrics-host", default="127.0.0.1")
    ap.add_argument("--status", metavar="URL", default=None,
                    help="one-shot: fetch /fleet from a running scheduler's "
                         "metrics endpoint (host:port or full URL), "
                         "pretty-print, exit")
    args = ap.parse_args()
    if args.status is not None:
        url = args.status
        if "://" not in url:
            url = "http://" + url
        if not url.rstrip("/").endswith("/fleet"):
            url = url.rstrip("/") + "/fleet"
        with urllib.request.urlopen(url, timeout=5) as resp:
            snap = json.load(resp)
        json.dump(snap, sys.stdout, indent=2, sort_keys=True)
        print()
        return
    telemetry.enable()
    sched = FleetScheduler(
        host=args.host, port=args.port,
        worker_timeout_s=args.worker_timeout,
        mem_budget_bytes=args.mem_budget_mb * 1024 * 1024,
    )
    exporter = None
    if args.metrics_port is not None:
        exporter = start_fleet_exporter(
            sched.observer, port=args.metrics_port, host=args.metrics_host
        )
        print(f"metrics on http://{args.metrics_host}:{exporter.port}"
              f"/metrics (+ /fleet, /qos)", flush=True)
    print(f"fleet scheduler on {sched.local_addr}", flush=True)
    last_report = 0.0
    try:
        while True:
            sched.poll()
            now = time.monotonic()
            if now - last_report >= 5.0:
                last_report = now
                snap = sched.fleet_snapshot(tail=4)
                if snap["workers"] or snap["lobbies"]:
                    print(json.dumps(
                        {k: snap[k]
                         for k in ("schema", "workers", "lobbies", "alerts")}
                    ), flush=True)
            time.sleep(0.002)
    except KeyboardInterrupt:
        pass
    finally:
        sched.close()
        if exporter is not None:
            exporter.close()


if __name__ == "__main__":
    main()
