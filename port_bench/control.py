"""The control of the comparison, and sound readings, on the card.

Runs a cell in one process on several seeds, each run as the benchmark
runs it, and prints each run's compared numbers as one JSON line:

    python3 -m port_bench.control --workload <name> --seconds <s> --seeds <n> [<n> ...] [--arm control|program]

``--arm control`` (the default) switches on the program's own
lower-precision path: every snapshot kept in bfloat16
(``QuantizeStrategy``), so that a rollback restores rounded states, the
step below the float32 the configuration states.  Its runs have to come
out not correct; their readings are each limit's upper reading.
``--arm program`` reads sound runs the same way.  The benchmark's own
runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ARMS = {"control": {"config": {"snapshots": "bf16"}}, "program": {}}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--arm", choices=sorted(ARMS), default="control")
    args = p.parse_args(argv)

    from .harness import run_cell

    for seed in args.seeds:
        out = run_cell(Path.cwd(), args.workload, seed, args.seconds, False,
                       overrides=ARMS[args.arm])
        print(json.dumps({"workload": args.workload, "arm": args.arm, "seed": seed,
                          "correct": out["line"]["correct"],
                          "checks": {k: c["value"] for k, c in out["checks"].items()},
                          "compared": {k: out["work"][k] for k in
                                       ("states_compared", "checksums_compared")}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
