#!/usr/bin/env python
"""box_game P2P CLI on the port (the twin of ``examples/box_game_p2p.py``):
2-4 players over UDP (or framed TCP), desync detection interval 10,
max_prediction 12, input_delay 2, event and network-stats printers.  Runs
on the card unless ``BGT_PLATFORM=cpu``.

Run two processes:
    python examples_torch/box_game_p2p.py --local-port 8081 --players local 127.0.0.1:8082
    python examples_torch/box_game_p2p.py --local-port 8082 --players 127.0.0.1:8081 local
"""

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
    TcpNonBlockingSocket,
    UdpNonBlockingSocket,
)
from bevy_ggrs_tpu_torch.models import box_game


def parse_addr(s):
    host, port = s.rsplit(":", 1)
    return (host, int(port))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--local-port", type=int, required=True)
    ap.add_argument("--players", nargs="+", required=True,
                    help="'local' or host:port per handle")
    ap.add_argument("--spectators", nargs="*", default=[])
    ap.add_argument("--input-delay", type=int, default=2)
    ap.add_argument("--max-prediction", type=int, default=12)
    ap.add_argument("--fps", type=int, default=60)
    ap.add_argument("--frames", type=int, default=600)
    ap.add_argument("--canonical", action="store_true",
                    help="the fixed-depth canonical program (max_prediction + 2 "
                         "frames of compute per dispatch)")
    ap.add_argument("--tcp", action="store_true",
                    help="framed-TCP transport instead of UDP (all peers must agree)")
    args = ap.parse_args()
    print(f"device: {device_label(DEVICE)}", flush=True)

    app = box_game.make_app(
        num_players=len(args.players), fps=args.fps,
        canonical_depth=(args.max_prediction + 2) if args.canonical else None,
        device=DEVICE,
    )
    sock = (TcpNonBlockingSocket if args.tcp else UdpNonBlockingSocket)(args.local_port)
    b = (
        SessionBuilder.for_app(app)
        .with_num_players(len(args.players))
        .with_input_delay(args.input_delay)
        .with_max_prediction_window(args.max_prediction)
        .with_desync_detection_mode(DesyncDetection.on(10))
    )
    local_handle = None
    for handle, spec in enumerate(args.players):
        if spec == "local":
            b.add_player(PlayerType.LOCAL, handle)
            local_handle = handle
        else:
            b.add_player(PlayerType.REMOTE, handle, parse_addr(spec))
    for i, spec in enumerate(args.spectators):
        b.add_player(PlayerType.SPECTATOR, len(args.players) + i, parse_addr(spec))
    session = b.start_p2p_session(sock)

    def read_inputs(handles):
        # demo input: the local player circles (right 60 frames, up 60, ...)
        phase = (runner.frame // 60) % 4
        kw = [dict(right=True), dict(up=True), dict(left=True), dict(down=True)][phase]
        return {h: box_game.keys_to_input(**kw) for h in handles}

    runner = GgrsRunner(app, session, read_inputs=read_inputs,
                        on_event=lambda e: print(f"event: {e}"))
    last = time.perf_counter()
    last_print = 0.0
    while runner.frame < args.frames:
        now = time.perf_counter()
        runner.update(now - last)
        last = now
        if now - last_print > 1.0:
            last_print = now
            pos = runner.world.comps["pos"]
            print(f"frame {runner.frame} confirmed {runner.confirmed} "
                  f"pos0={pos[0].tolist()}")
            for h in range(len(args.players)):
                if h != local_handle:
                    try:
                        s = session.network_stats(h)
                        print(f"  stats p{h}: ping={s.ping_ms:.1f}ms "
                              f"kbps={s.kbps_sent:.1f} queue={s.send_queue_len}")
                    except Exception:
                        pass
        time.sleep(0.001)
    print(f"done at frame {runner.frame}")


if __name__ == "__main__":
    main()
