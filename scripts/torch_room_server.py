#!/usr/bin/env python
"""Standalone room/signaling server on the port (the twin of
``scripts/room_server.py``): hosts rooms, pushes rosters, relays datagrams
for peers that cannot reach each other directly.

    python scripts/torch_room_server.py --port 3536

With ``--metrics-port`` the process also serves the port's telemetry
registry as Prometheus text (``GET /metrics``), the lobby QoS snapshot as
JSON (``GET /qos``) and a bounded Chrome-trace export (``GET /trace``);
the ``lobby_qos_score`` gauges are refreshed in the 5 s reporting loop:

    python scripts/torch_room_server.py --port 3536 --metrics-port 9464

The server runs no model and touches no device.
"""

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from bevy_ggrs_tpu_torch import telemetry
from bevy_ggrs_tpu_torch.session.room import RoomServer


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--port", type=int, default=3536)
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--timeout", type=float, default=5.0, help="member silence timeout (s)")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="serve Prometheus /metrics on this port (0 = any free port)")
    ap.add_argument("--metrics-host", default="127.0.0.1")
    ap.add_argument("--join-token", default=None,
                    help="shared-secret join token: JOINs without it are rejected "
                         "with a reason (off by default)")
    args = ap.parse_args()
    exporter = None
    if args.metrics_port is not None:
        telemetry.enable()
        exporter = telemetry.start_http_exporter(port=args.metrics_port,
                                                 host=args.metrics_host)
        base = f"http://{args.metrics_host}:{exporter.port}"
        print(f"metrics on {base}/metrics", flush=True)
        print(f"qos on {base}/qos", flush=True)
        print(f"trace on {base}/trace  (Chrome-trace JSON, ?n= caps events)", flush=True)
    server = RoomServer(port=args.port, host=args.host, member_timeout_s=args.timeout,
                        join_token=args.join_token)
    print(f"room server on {server.local_addr}", flush=True)
    last_report = 0.0
    try:
        while True:
            server.poll()
            now = time.monotonic()
            if now - last_report >= 5.0:
                last_report = now
                rooms = {room: sorted(members) for room, members in server.rooms.items()}
                telemetry.gauge_set("room_count", len(rooms), "active rooms")
                telemetry.gauge_set("room_members", sum(len(m) for m in rooms.values()),
                                    "members across all rooms")
                telemetry.update_qos_gauges()
                if rooms:
                    print(f"rooms: {rooms}", flush=True)
            time.sleep(0.002)
    except KeyboardInterrupt:
        pass
    finally:
        server.close()
        if exporter is not None:
            exporter.close()


if __name__ == "__main__":
    main()
