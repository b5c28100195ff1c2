#!/usr/bin/env python
"""E2E smoke of the PyTorch port: two P2P runners over real loopback UDP
sockets — builder, UDP transport, sync handshake, protocol, the runner's
default dispatch path (pipelined, packed, donating) and checksum
readback.  Exits nonzero on failure.

The twin of ``scripts/e2e_p2p_check.py``, with the same settings (input
delay 2, prediction window 8, two ``UdpNonBlockingSocket``s on
127.0.0.1, inputs from ``default_rng(42 + peer)``) and the same two
phases: lockstep, then peer 1 ticking every third host frame with three
times the delta, so peer 0 predicts its inputs and rolls back.  Desync
detection compares checksums every frame, and the run fails on any
``DesyncDetected``.  The handshake has 60 s; the phases count ticks.

Usage: python scripts/torch_e2e_p2p_check.py [--ticks 60] [--device cuda|cpu]

``chip_smoke.py`` runs the same functions on the card (phase ``surface``).
"""

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np

from bevy_ggrs_tpu_torch import (
    DesyncDetection,
    GgrsRunner,
    PlayerType,
    SessionBuilder,
    UdpNonBlockingSocket,
)
from bevy_ggrs_tpu_torch.session.events import DesyncDetected, SessionState

HANDSHAKE_S = 60.0


def random_inputs(i: int):
    """Peer ``i``'s input function: the JAX script's random pad bits."""
    rng = np.random.default_rng(42 + i)
    return lambda handles: {h: np.uint8(rng.integers(0, 16)) for h in handles}


def make_pair(make_app, inputs=random_inputs) -> list:
    """Two runners of ``make_app()`` apps over loopback UDP;
    ``inputs(i)`` is peer ``i``'s input function."""
    socks = [UdpNonBlockingSocket(0, host="127.0.0.1") for _ in range(2)]
    addrs = [("127.0.0.1", s.local_addr[1]) for s in socks]
    runners = []
    for i in range(2):
        app = make_app()
        session = (
            SessionBuilder(input_shape=app.input_shape, input_dtype=app.input_dtype)
            .with_num_players(2)
            .with_input_delay(2)
            .with_max_prediction_window(8)
            .with_desync_detection_mode(DesyncDetection.on(1))
            .add_player(PlayerType.LOCAL, i)
            .add_player(PlayerType.REMOTE, 1 - i, addrs[1 - i])
            .start_p2p_session(socks[i])
        )
        runners.append(GgrsRunner(app, session, read_inputs=inputs(i)))
    return runners


def handshake(runners) -> float:
    """Poll both peers until RUNNING; returns the seconds it took."""
    t0 = time.perf_counter()
    while any(r.session.current_state() != SessionState.RUNNING for r in runners):
        for r in runners:
            r.update(0.0)
        time.sleep(0.001)
        if time.perf_counter() - t0 > HANDSHAKE_S:
            raise SystemExit("torch_e2e_p2p_check: sync handshake timed out")
    return time.perf_counter() - t0


def play(runners, ticks: int, log=None) -> None:
    """The lockstep phase, then the staggered phase, ``ticks`` host
    frames each."""
    for tick in range(ticks):
        for r in runners:
            r.update(1 / 60)
        if log is not None and tick % 20 == 0:
            log(f"tick {tick} frames {runners[0].frame} {runners[1].frame}")
    for tick in range(ticks):
        runners[0].update(1 / 60)
        if tick % 3 == 2:
            runners[1].update(3 / 60)


def desyncs(runner) -> list:
    """The runner's ``DesyncDetected`` events."""
    return [e for e in runner.events if isinstance(e, DesyncDetected)]


def check(runners, ticks: int, moved: str = "pos") -> dict:
    """Finish both runners and hold the run to the JAX script's asserts
    (both peers advanced, rollbacks, ``moved`` changed) and to zero
    ``DesyncDetected``; returns the peers' stats."""
    for r in runners:
        r.finish()
    keys = ("ticks", "rollbacks", "device_dispatches", "frame", "confirmed")
    stats = [{k: r.stats()[k] for k in keys} for r in runners]
    for i, s in enumerate(stats):
        if s["frame"] <= ticks // 2:
            raise SystemExit(f"torch_e2e_p2p_check: peer {i} did not advance: {s}")
    if sum(s["rollbacks"] for s in stats) == 0:
        raise SystemExit("torch_e2e_p2p_check: the staggered phase produced no "
                         "rollbacks — the prediction path went unexercised")
    found = [len(desyncs(r)) for r in runners]
    if any(found):
        raise SystemExit(f"torch_e2e_p2p_check: DesyncDetected {found}")
    col = runners[0].read_components([moved])[moved]
    if not np.abs(col).sum() > 0:
        raise SystemExit(f"torch_e2e_p2p_check: {moved} never moved")
    return {"stats": stats, "desyncs": found, "moved": moved, "shape": list(col.shape)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ticks", type=int, default=60)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()

    from bevy_ggrs_tpu_torch.models import box_game

    runners = make_pair(lambda: box_game.make_app(num_players=2, device=args.device))
    print(f"RUNNING after {handshake(runners):.2f}s on {runners[0].app.device}", flush=True)
    play(runners, args.ticks, log=lambda line: print(line, flush=True))
    out = check(runners, args.ticks)
    print("stats0:", out["stats"][0])
    print("stats1:", out["stats"][1])
    print("pos readback:", out["shape"], "moved: True")
    print("E2E P2P OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
