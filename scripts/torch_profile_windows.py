#!/usr/bin/env python
"""Do ``torch.profiler`` windows of identical work record identical events?

    python scripts/torch_profile_windows.py [--windows 10] [--chunks 10]

Runs on the card.  The same work — ``--chunks`` chunks of one fleet lobby
(``stress_soa`` 10,000 entities, 16 frames each through the packed
canonical program: one pinned upload, ~816 kernels and one checksum read
per chunk) — is profiled ``--windows`` times as a plain window and as many
times behind one traced, discarded warm-up call (``chip_smoke.py``
``warm_profile``), in turns, twice.  Each line counts the distinct event
censuses (host-to-device copies pinned and pageable, device-to-host
copies, kernel launches) the windows of one kind read: identical work
should read one census."""

import argparse
import collections
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke as cs  # noqa: E402
from bevy_ggrs_tpu_torch.fleet import LobbySim, LobbySpec  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--windows", type=int, default=10)
    ap.add_argument("--chunks", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    cs.phase_build()
    dev = torch.device("cuda", 0)
    sim = LobbySim(LobbySpec(lobby_id="x", entities=10_000, target_frames=10**9), device=dev)
    for _ in range(3):
        sim.step()
    torch.cuda.synchronize()

    def plain():
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(args.chunks):
                sim.step()
            torch.cuda.synchronize()
        return cs.copy_counts(prof)[0]

    def warmed():
        return cs.copy_counts(cs.warm_profile(sim.step, args.chunks)[0])[0]

    print(cs.card_line(), flush=True)
    for name, fn in (("plain", plain), ("warmed", warmed)) * 2:
        seen = collections.Counter(json.dumps(fn(), sort_keys=True)
                                   for _ in range(args.windows))
        print(json.dumps({"windows": name, "chunks": args.chunks, "censuses": dict(seen)}),
              flush=True)


if __name__ == "__main__":
    main()
