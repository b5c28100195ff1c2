"""The ``stress_soa`` frame in plain PyTorch, from its semantics.

Positions and velocities under gravity, one frame of ``dt = 1 / fps``
seconds: ``vy += g * dt`` (the product rounded to float32 first), then each
position moves by its velocity times ``dt`` (a product and a sum, each
rounded), and a coordinate past ``|50|`` reverses its velocity and is
clamped to the bound.  Every entity of the benchmark's worlds is live.
The step reads no input: a frame's result is the same whatever the
players pressed, so the world at frame ``f`` is ``f`` steps of the
initial world.

``dtype`` sets the precision the reference computes in (float32 as the
configuration states; the control computes in bfloat16).
"""

from __future__ import annotations

import numpy as np
import torch

GRAVITY = np.float32(-9.8)
BOUND = 50.0


def frame_dt(fps: int) -> np.float32:
    return np.float32(1.0 / fps)


def step(cols: dict, dt: np.float32) -> dict:
    """One frame of every world in ``cols`` (name -> ``[..., N]``)."""
    gdt = float(GRAVITY * dt)
    d = float(dt)
    vy = cols["vy"] + gdt
    new = {"vx": cols["vx"], "vy": vy, "vz": cols["vz"],
           "x": cols["x"] + cols["vx"] * d,
           "y": cols["y"] + vy * d,
           "z": cols["z"] + cols["vz"] * d}
    for p, v in (("x", "vx"), ("y", "vy"), ("z", "vz")):
        over = new[p].abs() > BOUND
        new[v] = torch.where(over, -new[v], new[v])
        new[p] = new[p].clamp(-BOUND, BOUND)
    return new
