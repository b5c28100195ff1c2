#!/usr/bin/env python
"""Fleet worker host process of the PyTorch port: registers with a
scheduler and runs lobbies on one device.

    python scripts/torch_fleet_worker.py --scheduler 127.0.0.1:3600 \
        --worker-id w0 --capacity 4 [--device cuda]

One process = one worker = one card's worth of lobby hosting.  The worker
polls forever: it accepts PLACE/DRAIN/RESUME/DROP commands, advances hosted
lobbies by a bounded frame budget per poll, ships confirmed checkpoints
back to the scheduler (the failover source), and heartbeats its load/QoS
stats.  The flags are ``scripts/fleet_worker.py``'s, and the wire is the
same, so this worker registers with either package's scheduler.

The device is ``--device`` when given, else what ``BGT_PLATFORM`` (or
``JAX_PLATFORMS``) names (``cpu`` runs on the CPU), else CUDA, which raises
without a card (``bevy_ggrs_tpu_torch/utils/platform.py``).

``--trace-out`` dumps this worker's Chrome trace periodically with an
atomic replace, so the file is valid JSON even if the process is
SIGKILLed mid-game: a fleet's traces merge with ``telemetry.merge_traces``
(scheduler first)."""

import argparse
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from bevy_ggrs_tpu_torch import telemetry  # noqa: E402
from bevy_ggrs_tpu_torch.fleet import FleetWorker  # noqa: E402
from bevy_ggrs_tpu_torch.utils.platform import apply_platform_env  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scheduler", default="127.0.0.1:3600",
                    help="scheduler host:port")
    ap.add_argument("--worker-id", required=True)
    ap.add_argument("--capacity", type=int, default=4,
                    help="max concurrently hosted lobbies")
    ap.add_argument("--duration", type=float, default=None,
                    help="exit after this many seconds (default: run forever)")
    ap.add_argument("--ckpt-every", type=int, default=120,
                    help="confirmed-checkpoint shipping cadence (frames)")
    ap.add_argument("--step-budget", type=int, default=16,
                    help="max frames per lobby per poll")
    ap.add_argument("--pace-fps", type=float, default=0.0,
                    help="cap running lobbies to this realtime frame rate "
                         "(0 = unpaced)")
    ap.add_argument("--device", default=None,
                    help="torch device of the hosted lobbies (default: "
                         "BGT_PLATFORM / JAX_PLATFORMS, else cuda)")
    ap.add_argument("--trace-out", default=None,
                    help="dump this worker's Chrome trace here periodically "
                         "(atomic replace — survives SIGKILL)")
    ap.add_argument("--trace-every", type=float, default=1.0,
                    help="trace dump cadence with --trace-out (s)")
    args = ap.parse_args()
    device = args.device if args.device is not None else apply_platform_env()
    telemetry.enable()
    host, _, port = args.scheduler.rpartition(":")
    worker = FleetWorker(
        args.worker_id, (host or "127.0.0.1", int(port)),
        capacity=args.capacity, ckpt_every_frames=args.ckpt_every,
        step_budget=args.step_budget, pace_fps=args.pace_fps, device=device,
    )
    print(f"fleet worker {args.worker_id} on {worker.local_addr} ({worker.device}) "
          f"-> scheduler {args.scheduler}", flush=True)

    def _dump_trace() -> None:
        tmp = args.trace_out + ".tmp"
        telemetry.write_trace(tmp, process_name=f"worker:{args.worker_id}")
        os.replace(tmp, args.trace_out)

    try:
        if args.trace_out is None:
            worker.run(duration_s=args.duration)
        else:
            # manual run() loop so a reader always finds a complete trace
            # file, even after this process is SIGKILLed mid-game
            worker.register()
            t0 = time.monotonic()
            next_dump = t0 + args.trace_every
            while (args.duration is None
                   or time.monotonic() - t0 < args.duration):
                worker.poll()
                now = time.monotonic()
                if now >= next_dump:
                    next_dump = now + args.trace_every
                    _dump_trace()
                time.sleep(0.005)
    except KeyboardInterrupt:
        pass
    finally:
        if args.trace_out is not None:
            _dump_trace()
        worker.close()


if __name__ == "__main__":
    main()
