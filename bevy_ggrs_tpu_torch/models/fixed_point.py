"""fixed_point — integer-math box_game for cross-device determinism.

Port of ``bevy_ggrs_tpu/models/fixed_point.py``: the box_game ice physics
in Q16.16 fixed point (int32 columns, shifts and integer multiplies only),
so the CPU, the card and the JAX package all produce bit-identical states
and therefore equal checksums.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..app import App
from ..ops.resim import StepCtx
from ..snapshot.world import WorldState, active_mask, spawn
from ..utils.device import DeviceLike

FP = 16  # fractional bits
ONE = 1 << FP

ACCEL = ONE // 200  # per-frame acceleration in Q16.16
# friction 255/256 per frame, exact in integers
ARENA_HALF = 4 * ONE


def step(world: WorldState, ctx: StepCtx) -> WorldState:
    """Q16.16 integer box_game step (bit-identical across devices)."""
    handle = world.comps["handle"]
    mask = active_mask(world) & world.has["handle"]
    n_inputs = ctx.inputs.shape[0]
    inp = ctx.inputs.reshape(-1)[handle.clamp(0, n_inputs - 1).long()]
    inp = torch.where(mask, inp, 0).to(torch.int32)

    def bit(b):
        return (inp >> b) & 1

    acc_x = (bit(3) - bit(2)) * ACCEL
    acc_z = (bit(1) - bit(0)) * ACCEL

    vel = world.comps["vel"] + torch.stack([acc_x, acc_z], dim=-1)
    vel = (vel * 255) >> 8  # friction, arithmetic shift (exact, wrapping-safe)

    pos = torch.clamp(world.comps["pos"] + vel, -ARENA_HALF, ARENA_HALF)

    m = mask[:, None]
    return dataclasses.replace(
        world,
        comps={
            **world.comps,
            "vel": torch.where(m, vel, world.comps["vel"]),
            "pos": torch.where(m, pos, world.comps["pos"]),
        },
    )


def make_app(num_players: int = 2, capacity: int = 8, fps: int = 60,
             device: DeviceLike = None) -> App:
    """Build the fixed-point App (int32 pos/vel in Q16.16)."""
    app = App(num_players=num_players, capacity=capacity, fps=fps,
              input_shape=(), input_dtype=np.uint8, device=device)
    app.rollback_component("pos", (2,), torch.int32, checksum=True)
    app.rollback_component("vel", (2,), torch.int32, checksum=True)
    app.rollback_component("handle", (), torch.int32, checksum=True)
    app.set_step(step)

    def setup(world):
        for h in range(num_players):
            world, _ = spawn(
                app.reg, world,
                {"pos": np.array([(h * 2 - 1) * 2 * ONE, 0], np.int32),
                 "vel": np.zeros(2, np.int32),
                 "handle": h},
            )
        return world

    app.set_setup(setup)
    return app


def to_float(q):
    """Q16.16 -> float for display."""
    return np.asarray(q, np.float64) / ONE
