"""The benchmark's inputs: each game world's initial columns, drawn from
the seed on the device.

Both sides take their worlds from here: the program through its own
``spawn_many`` (``drivers/common.py``), the plain reference directly.
World ``w`` of seed ``s`` is the same columns every time, on one device:
six float32 columns of ``n`` entities,
positions uniform in [-40, 40) and velocities in [-5, 5), as the
``stress_soa`` model's own set-up draws them (on the host there).
"""

from __future__ import annotations

import torch

COLUMNS = ("x", "y", "z", "vx", "vy", "vz")

# a 64-bit generator seed from (seed, world); seeds reach a little over 2**31
_WORLD_STRIDE = 1 << 20


def generator_seed(seed: int, world: int) -> int:
    return (int(seed) * _WORLD_STRIDE + int(world)) % (1 << 63)


def initial_columns(seed: int, world: int, n: int, device) -> dict:
    """World ``world``'s six ``[n]`` float32 columns, in one draw."""
    dev = torch.device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(generator_seed(seed, world))
    u = torch.rand((len(COLUMNS), n), generator=g, device=dev, dtype=torch.float32)
    pos = u[:3] * 80.0 - 40.0
    vel = u[3:] * 10.0 - 5.0
    return {name: (pos[i] if i < 3 else vel[i - 3]).contiguous()
            for i, name in enumerate(COLUMNS)}

