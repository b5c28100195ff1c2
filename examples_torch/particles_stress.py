#!/usr/bin/env python
"""particles stress CLI on the port (the twin of
``examples/particles_stress.py``): a P2P (or SyncTest) session spawning
``--rate`` particles a frame from rollback-safe seeded randomness, with
full-state checksums and desync panic or continue.  Runs on the card
unless ``BGT_PLATFORM=cpu``."""

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from bevy_ggrs_tpu_torch.utils.platform import apply_platform_env, device_label

DEVICE = apply_platform_env()

from bevy_ggrs_tpu_torch import (
    DesyncDetection,
    GgrsRunner,
    PlayerType,
    SessionBuilder,
    UdpNonBlockingSocket,
)
from bevy_ggrs_tpu_torch.models import particles
from bevy_ggrs_tpu_torch.session.events import DesyncDetected
from bevy_ggrs_tpu_torch.snapshot.world import active_count


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rate", type=int, default=100, help="particles per frame")
    ap.add_argument("--ttl", type=int, default=120)
    ap.add_argument("--synctest", action="store_true")
    ap.add_argument("--check-distance", type=int, default=7)
    ap.add_argument("--local-port", type=int, default=0)
    ap.add_argument("--players", nargs="*", default=["local", "local"])
    ap.add_argument("--frames", type=int, default=600)
    ap.add_argument("--continue-after-desync", action="store_true")
    ap.add_argument("--quantize", action="store_true",
                    help="store float snapshots as bf16 (the strategy A/B knob)")
    args = ap.parse_args()
    print(f"device: {device_label(DEVICE)}", flush=True)

    app = particles.make_app(rate=args.rate, ttl=args.ttl,
                             num_players=max(len(args.players), 1),
                             quantize=args.quantize, device=DEVICE)
    b = SessionBuilder.for_app(app).with_num_players(app.num_players)

    def on_event(e):
        print(f"event: {e}")
        if isinstance(e, DesyncDetected) and not args.continue_after_desync:
            raise SystemExit(f"DESYNC: {e}")

    synctest = args.synctest or all(p == "local" for p in args.players)
    if synctest:
        session = b.with_check_distance(args.check_distance).start_synctest_session()
        runner = GgrsRunner(app, session, on_mismatch=lambda e: on_event(e))
    else:
        sock = UdpNonBlockingSocket(args.local_port)
        b.with_desync_detection_mode(DesyncDetection.on(10)).with_input_delay(2)
        for handle, spec in enumerate(args.players):
            if spec == "local":
                b.add_player(PlayerType.LOCAL, handle)
            else:
                host, port = spec.rsplit(":", 1)
                b.add_player(PlayerType.REMOTE, handle, (host, int(port)))
        session = b.start_p2p_session(sock)
        runner = GgrsRunner(app, session, on_event=on_event)

    t0 = time.perf_counter()
    last = t0
    for _ in range(args.frames):
        if synctest:
            runner.tick()  # one frame a pass, however long a pass takes
            continue
        now = time.perf_counter()
        runner.update(max(now - last, 1.0 / app.fps))
        last = now
    runner.finish()
    dt = time.perf_counter() - t0
    n = int(active_count(runner.world))
    print(f"{runner.frame} frames, {n} live particles, {dt:.2f}s "
          f"({runner.frame / dt:.0f} fps incl. resim)")


if __name__ == "__main__":
    main()
