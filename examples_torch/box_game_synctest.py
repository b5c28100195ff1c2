#!/usr/bin/env python
"""box_game SyncTest CLI on the port: continuous check-distance
resimulation with panic-on-mismatch (the twin of
``examples/box_game_synctest.py``).  Runs on the card unless
``BGT_PLATFORM=cpu``."""

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from bevy_ggrs_tpu_torch.utils.platform import apply_platform_env, device_label

DEVICE = apply_platform_env()

from bevy_ggrs_tpu_torch import GgrsRunner, SessionBuilder
from bevy_ggrs_tpu_torch.models import box_game


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--num-players", type=int, default=2)
    ap.add_argument("--check-distance", type=int, default=7)
    ap.add_argument("--input-delay", type=int, default=0)
    ap.add_argument("--frames", type=int, default=600)
    args = ap.parse_args()
    print(f"device: {device_label(DEVICE)}", flush=True)

    app = box_game.make_app(num_players=args.num_players, device=DEVICE)
    session = (
        SessionBuilder.for_app(app)
        .with_num_players(args.num_players)
        .with_check_distance(args.check_distance)
        .with_input_delay(args.input_delay)
        .start_synctest_session()
    )

    def on_mismatch(e):
        raise SystemExit(f"SYNCTEST MISMATCH: {e}")  # panic observer

    def read_inputs(handles):
        phase = (runner.frame // 30) % 4
        kw = [dict(right=True), dict(up=True), dict(left=True), dict(down=True)][phase]
        return {h: box_game.keys_to_input(**kw) for h in handles}

    runner = GgrsRunner(app, session, read_inputs=read_inputs, on_mismatch=on_mismatch)
    t0 = time.perf_counter()
    for _ in range(args.frames):
        runner.tick()
    runner.finish()
    dt = time.perf_counter() - t0
    print(f"{args.frames} frames (x{args.check_distance + 1} resim each) in "
          f"{dt:.2f}s — no mismatches; pos0={runner.world.comps['pos'][0].tolist()}")


if __name__ == "__main__":
    main()
