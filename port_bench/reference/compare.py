"""The comparison that decides ``correct``.

What the window produced (``Game.outputs``): each game world's live
columns and every snapshot in its ring at the window's close (the states
a rollback restores), and the checksums the program confirmed at a sample
of frames drawn from the seed.  The reference steps each initial world
from frame 0, in float32 as the configuration states, and at every frame
that something was produced for compares:

- ``state_gap``: the largest absolute difference between a produced
  column and the reference's, over every entity of every compared state;
- ``checksum_mismatches``: confirmed checksums that differ from the
  reference checksum of the reference's world at that frame.

It runs world batch by world batch, so that it fits beside the produced
states: ``batch`` initial worlds at a time.
"""

from __future__ import annotations

from collections import defaultdict

import torch

from ..worlds import COLUMNS, initial_columns
from . import fold
from .stress_soa import frame_dt, step


def compare(states, checks, seed: int, n: int, fps: int, device,
            dtype=torch.float32, batch: int = 8) -> dict:
    """Readings of the two compared numbers (module docstring), with the
    counts compared.  ``dtype`` is the reference's precision."""
    dt = frame_dt(fps)
    worlds = sorted({w for w, _, _ in states} | {w for w, _, _ in checks})
    gap = 0.0
    mismatches = 0
    for lo in range(0, len(worlds), batch):
        block = worlds[lo:lo + batch]
        row = {w: i for i, w in enumerate(block)}
        at_state = defaultdict(list)
        for w, f, cols in states:
            if w in row:
                at_state[f].append((row[w], cols))
        at_check = defaultdict(list)
        for w, f, value in checks:
            if w in row:
                at_check[f].append((row[w], value))
        last = max([*at_state, *at_check], default=-1)
        cols = _initial(seed, block, n, device, dtype)
        for f in range(last + 1):
            for r, got in at_state.get(f, ()):
                for name in COLUMNS:
                    d = (got[name].to(torch.float32) - cols[name][r].to(torch.float32)).abs()
                    g = float(d.max())
                    if not g <= gap:  # a NaN reads as the widest gap
                        gap = g if g == g else float("inf")
            if f in at_check:
                want = fold.checksums({k: v.to(torch.float32) for k, v in cols.items()},
                                      COLUMNS)
                mismatches += sum(value != want[r] for r, value in at_check[f])
            if f < last:
                cols = step(cols, dt)
    return {"state_gap": gap, "checksum_mismatches": mismatches,
            "states_compared": len(states), "checksums_compared": len(checks)}


def _initial(seed: int, block, n: int, device, dtype) -> dict:
    per = [initial_columns(seed, w, n, device) for w in block]
    return {name: torch.stack([p[name] for p in per]).to(dtype) for name in COLUMNS}
