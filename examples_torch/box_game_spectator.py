#!/usr/bin/env python
"""box_game spectator CLI on the port (the twin of
``examples/box_game_spectator.py``): follow a host session read-only.
Runs on the card unless ``BGT_PLATFORM=cpu``.

    python examples_torch/box_game_spectator.py --local-port 8090 \
        --host 127.0.0.1:8081 --num-players 2
"""

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from bevy_ggrs_tpu_torch.utils.platform import apply_platform_env, device_label

DEVICE = apply_platform_env()

from bevy_ggrs_tpu_torch import GgrsRunner, SessionBuilder, UdpNonBlockingSocket
from bevy_ggrs_tpu_torch.models import box_game


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--local-port", type=int, required=True)
    ap.add_argument("--host", required=True)
    ap.add_argument("--num-players", type=int, default=2)
    ap.add_argument("--frames", type=int, default=600)
    args = ap.parse_args()
    print(f"device: {device_label(DEVICE)}", flush=True)

    host, port = args.host.rsplit(":", 1)
    app = box_game.make_app(num_players=args.num_players, device=DEVICE)
    sock = UdpNonBlockingSocket(args.local_port)
    session = (
        SessionBuilder.for_app(app)
        .with_num_players(args.num_players)
        .start_spectator_session((host, int(port)), sock)
    )
    runner = GgrsRunner(app, session, on_event=lambda e: print(f"event: {e}"))
    last = time.perf_counter()
    last_print = 0.0
    while runner.frame < args.frames:
        now = time.perf_counter()
        runner.update(now - last)
        last = now
        if now - last_print > 1.0:
            last_print = now
            print(f"frame {runner.frame} (behind host: "
                  f"{session.frames_behind_host()}) "
                  f"pos0={runner.world.comps['pos'][0].tolist()}")
        time.sleep(0.001)


if __name__ == "__main__":
    main()
