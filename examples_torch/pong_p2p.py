#!/usr/bin/env python
"""Pong over P2P (or SyncTest with ``--synctest``) on the port (the twin
of ``examples/pong_p2p.py``): a complete game, with optional speculative
hedging of remote inputs through the canonical branched program
(``--speculate``).  Runs on the card unless ``BGT_PLATFORM=cpu``.

    python examples_torch/pong_p2p.py --synctest --frames 600
    python examples_torch/pong_p2p.py --local-port 8081 --players local 127.0.0.1:8082
    python examples_torch/pong_p2p.py --local-port 8082 --players 127.0.0.1:8081 local
"""

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from bevy_ggrs_tpu_torch.utils.platform import apply_platform_env, device_label

DEVICE = apply_platform_env()

import numpy as np

from bevy_ggrs_tpu_torch import (
    GgrsRunner,
    PlayerType,
    SessionBuilder,
    SpeculationConfig,
    UdpNonBlockingSocket,
    pad_candidates,
)
from bevy_ggrs_tpu_torch.models import pong


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--synctest", action="store_true")
    ap.add_argument("--check-distance", type=int, default=5)
    ap.add_argument("--local-port", type=int, default=0)
    ap.add_argument("--players", nargs="*", default=["local", "local"])
    ap.add_argument("--frames", type=int, default=1200)
    ap.add_argument("--speculate", action="store_true",
                    help="hedge predicted remote inputs (branch cache)")
    ap.add_argument("--canonical", action="store_true",
                    help="the fixed-depth canonical program")
    args = ap.parse_args()
    print(f"device: {device_label(DEVICE)}", flush=True)

    # --speculate adds fixed hedge lanes to the canonical program
    app = pong.make_app(canonical_depth=10 if args.canonical else None, device=DEVICE)
    if args.speculate:
        if not args.canonical:
            app.canonical_depth = 10
        app.canonical_branches = 4  # lane 0 real + 3 hedge candidates
    b = SessionBuilder.for_app(app).with_input_delay(1)

    def read_inputs(handles):
        # demo AI: each paddle chases the ball
        pos = runner.read_components(["pos", "kind"])
        kind = pos["kind"]
        balls = (kind == pong.K_BALL) & pos["__active__"]
        ball_y = float(pos["pos"][balls, 1][0]) if balls.any() else 0.0
        out = {}
        for h in handles:
            my_y = float(pos["pos"][h, 1])
            if ball_y > my_y + 0.2:
                out[h] = np.uint8(pong.UP)
            elif ball_y < my_y - 0.2:
                out[h] = np.uint8(pong.DOWN)
            else:
                out[h] = np.uint8(0)
        return out

    speculation = (SpeculationConfig(candidates_fn=pad_candidates(2, [1], [0, 1, 2]),
                                     depth=4) if args.speculate else None)

    if args.synctest or all(p == "local" for p in args.players):
        session = b.with_check_distance(args.check_distance).start_synctest_session()

        def on_mismatch(e):
            raise SystemExit(f"MISMATCH: {e}")

        runner = GgrsRunner(app, session, read_inputs=read_inputs, on_mismatch=on_mismatch)
        for _ in range(args.frames):
            runner.tick()
            if pong.winner(runner.world) >= 0:
                break
        runner.finish()
    else:
        sock = UdpNonBlockingSocket(args.local_port)
        for handle, spec in enumerate(args.players):
            if spec == "local":
                b.add_player(PlayerType.LOCAL, handle)
            else:
                host, port = spec.rsplit(":", 1)
                b.add_player(PlayerType.REMOTE, handle, (host, int(port)))
        session = b.start_p2p_session(sock)
        runner = GgrsRunner(app, session, read_inputs=read_inputs, speculation=speculation,
                            on_event=lambda e: print(f"event: {e}"))
        last = time.perf_counter()
        while runner.frame < args.frames and pong.winner(runner.world) < 0:
            now = time.perf_counter()
            runner.update(now - last)
            last = now
            time.sleep(0.001)

    score = runner.world.res["score"].tolist()
    w = pong.winner(runner.world)
    print(f"frame {runner.frame}: score {score[0]}-{score[1]}"
          + (f" — player {w} wins!" if w >= 0 else ""))
    print(f"stats: {runner.stats()}")


if __name__ == "__main__":
    main()
