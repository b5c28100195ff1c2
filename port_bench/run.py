"""Run one cell of the port's benchmark once, from the repository root:

    python3 -m port_bench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Prints the run's work per 100 ticks on one line, then the result as one
JSON object on the last line of standard output; the compared numbers,
each beside its limit, are the last lines of standard error.  Exits 3
without a result when the card the cell needs is not there, and 1
without a result when a module of JAX or of the JAX package was loaded.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path


def _cache_dirs(root: Path) -> None:
    """Build and kernel caches at fixed paths inside the checkout (the
    checksum pass's own build directory, ``bevy_ggrs_tpu_torch/_build``,
    is one already)."""
    cache = root / ".port_bench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    root = Path.cwd()
    _cache_dirs(root)

    from .harness import NoDevice, guarded_modules, run_cell

    try:
        out = run_cell(root, args.workload, args.seed, args.seconds, bool(args.trace))
    except NoDevice as e:
        print(f"port_bench: {e}", file=sys.stderr)
        return 3
    loaded = guarded_modules()
    if loaded:
        print(f"port_bench: the run loaded {', '.join(loaded)}", file=sys.stderr)
        return 1
    print(json.dumps(out["work"]), flush=True)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out["line"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
