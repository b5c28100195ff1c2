#!/usr/bin/env python
"""SyncTest checksum parity of the PyTorch port across devices
(``BASELINE.md`` metric 2).

The twin of ``scripts/parity_check.py``: the same 12-frame ``fixed_point``
resim (inputs from ``default_rng(7).integers(0, 16)``, every status
confirmed) on ``--device`` (CUDA by default, where the checksum fold
kernel runs) and on the CPU, whose checksums the plain torch fold
computes.  Integer sim math, so the 64-bit checksums must match frame by
frame: exit 1 otherwise.  The float ``box_game`` checksums are reported
for information only.

Usage: python scripts/torch_parity_check.py [--device cuda|cpu]
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np
import torch

FRAMES = 12


def run_on(device, make_app, k: int = FRAMES) -> list:
    """The scripted k-frame resim's checksums on ``device``, as ints."""
    from bevy_ggrs_tpu_torch.session.events import InputStatus
    from bevy_ggrs_tpu_torch.snapshot.checksum import checksum_to_int

    app = make_app(device=device)
    rng = np.random.default_rng(7)
    inputs = rng.integers(0, 16, (k, app.num_players)).astype(np.uint8)
    status = np.full((k, app.num_players), InputStatus.CONFIRMED, np.int8)
    dev = app.device
    _, _, checks = app.resim_fn(app.init_state(), torch.from_numpy(inputs).to(dev),
                                torch.from_numpy(status).to(dev), 0)
    return [checksum_to_int(c) for c in checks.cpu()]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()

    from bevy_ggrs_tpu_torch.models import box_game, fixed_point

    print(f"device: {args.device}, cpu: cpu")
    fp_dev = run_on(args.device, fixed_point.make_app)
    fp_cpu = run_on("cpu", fixed_point.make_app)
    exact = fp_dev == fp_cpu
    print(f"fixed-point parity ({args.device} vs cpu): "
          f"{'EXACT MATCH' if exact else 'MISMATCH'}")
    if not exact:
        for i, (a, b) in enumerate(zip(fp_dev, fp_cpu)):
            if a != b:
                print(f"  frame {i + 1}: {a:#018x} != {b:#018x}")
    bg_dev = run_on(args.device, box_game.make_app)
    bg_cpu = run_on("cpu", box_game.make_app)
    print("float box_game parity (informational): "
          f"{'match' if bg_dev == bg_cpu else 'differs (f32 across devices)'}")
    print(f"fixed-point last checksum: {fp_dev[-1]:#018x}")
    return 0 if exact else 1


if __name__ == "__main__":
    raise SystemExit(main())
