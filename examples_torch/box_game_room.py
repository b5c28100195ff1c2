#!/usr/bin/env python
"""box_game over room matchmaking on the port (the twin of
``examples/box_game_room.py``): join a room on
``scripts/torch_room_server.py``, learn the peers, derive handles from the
sorted peer ids, and play by peer-id addressing (``--relay`` forces the
relayed data plane).  Runs on the card unless ``BGT_PLATFORM=cpu``.

    python scripts/torch_room_server.py --port 3536
    python examples_torch/box_game_room.py --server 127.0.0.1:3536 --room demo
    python examples_torch/box_game_room.py --server 127.0.0.1:3536 --room demo
"""

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from bevy_ggrs_tpu_torch.utils.platform import apply_platform_env, device_label

DEVICE = apply_platform_env()

from bevy_ggrs_tpu_torch import (
    GgrsRunner,
    PlayerType,
    RoomSocket,
    SessionBuilder,
    SessionState,
    wait_for_players,
)
from bevy_ggrs_tpu_torch.models import box_game


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--server", default="127.0.0.1:3536")
    ap.add_argument("--room", default="demo")
    ap.add_argument("--players", type=int, default=2)
    ap.add_argument("--frames", type=int, default=600)
    ap.add_argument("--relay", action="store_true", help="force the relayed data plane")
    ap.add_argument("--peer-id", default=None)
    args = ap.parse_args()
    print(f"device: {device_label(DEVICE)}", flush=True)

    ip, port = args.server.rsplit(":", 1)
    sock = RoomSocket((ip, int(port)), args.room, peer_id=args.peer_id,
                      mode="relay" if args.relay else "direct")
    print(f"joined room '{args.room}' as {sock.peer_id}; waiting for "
          f"{args.players} players...", flush=True)
    wait_for_players(sock, args.players, timeout_s=60.0)
    # the game seats exactly --players: the FIRST n sorted peer ids play
    # (the same on every peer); a later arrival exits
    players = sock.players()[: args.players]
    handles = dict(enumerate(players))
    if sock.peer_id not in players:
        print(f"room already seated {args.players} players ({players}); "
              f"{sock.peer_id} is not among them — exiting", flush=True)
        sock.close()
        sys.exit(1)
    print(f"room full: {players}; handles: {handles}", flush=True)

    app = box_game.make_app(num_players=args.players, device=DEVICE)
    b = SessionBuilder.for_app(app).with_input_delay(2)
    my_handle = None
    for h, peer in handles.items():
        if peer == sock.peer_id:
            b.add_player(PlayerType.LOCAL, h)
            my_handle = h
        else:
            b.add_player(PlayerType.REMOTE, h, peer)
    session = b.start_p2p_session(sock)

    key = ["right", "down", "left", "up"][my_handle % 4]

    def read_inputs(hs):
        return {h: box_game.keys_to_input(**{key: True}) for h in hs}

    runner = GgrsRunner(app, session, read_inputs=read_inputs,
                        on_event=lambda e: print(f"event: {e}", flush=True))
    last = time.monotonic()
    while session.current_state() != SessionState.RUNNING:
        runner.update(0.0)
        time.sleep(0.002)
    print("synchronized; playing", flush=True)
    while runner.frame < args.frames:
        now = time.monotonic()
        runner.update(now - last)
        last = now
        time.sleep(0.001)
    print(f"done at frame {runner.frame}; checksum {runner.checksum:#018x}", flush=True)
    sock.close()


if __name__ == "__main__":
    main()
