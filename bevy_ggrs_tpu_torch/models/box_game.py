"""box_game — the canonical 2-4 player example model.

Port of ``bevy_ggrs_tpu/models/box_game.py``: each player is a cube on an
ice rink driven by a 4-bit direction bitmask input; acceleration from
input, friction decay, positions clamped to the rink, as one masked tensor
step over SoA columns.  The arithmetic runs op by op in float32 with the
JAX package's float32 constants.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..app import App
from ..ops.resim import StepCtx
from ..snapshot.world import WorldState, active_mask, spawn
from ..utils.device import DeviceLike

INPUT_UP = 1 << 0
INPUT_DOWN = 1 << 1
INPUT_LEFT = 1 << 2
INPUT_RIGHT = 1 << 3

MOVEMENT_SPEED = np.float32(0.005)
MAX_SPEED = np.float32(0.05)
FRICTION = np.float32(0.9975)
ARENA_HALF = np.float32(4.0)


def step(world: WorldState, ctx: StepCtx) -> WorldState:
    """Ice-rink cube physics: input acceleration, friction, clamped arena."""
    handle = world.comps["handle"].to(torch.int32)
    mask = active_mask(world) & world.has["handle"]
    # gather this entity's input byte by player handle
    n_inputs = ctx.inputs.shape[0]
    inp = ctx.inputs.reshape(-1)[handle.clamp(0, n_inputs - 1).long()]
    inp = torch.where(mask, inp, 0).to(torch.uint8)

    def bit(b):
        return (torch.bitwise_right_shift(inp, b) & 1).to(torch.float32)

    acc_x = (bit(3) - bit(2)) * MOVEMENT_SPEED  # right - left
    acc_z = (bit(1) - bit(0)) * MOVEMENT_SPEED  # down - up

    vel = world.comps["vel"] + torch.stack([acc_x, acc_z], dim=-1)
    vel = vel * FRICTION
    speed = torch.sqrt(torch.sum(vel * vel, dim=-1, keepdim=True))
    # a true division: python-scalar / tensor is reciprocal-then-multiply
    limit = torch.full_like(speed, MAX_SPEED) / torch.clamp_min(speed, 1e-9)
    vel = vel * torch.where(speed > MAX_SPEED, limit, 1.0)

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


def setup(app: App):
    """Spawn one cube per player on a circle of radius 2."""

    def fn(world: WorldState) -> WorldState:
        n = app.num_players
        for h in range(n):
            angle = 2.0 * np.pi * h / n
            pos = np.array([np.cos(angle) * 2.0, np.sin(angle) * 2.0], np.float32)
            world, _ = spawn(
                app.reg, world,
                {"pos": pos, "vel": np.zeros(2, np.float32), "handle": h},
            )
        return world

    return fn


def make_app(num_players: int = 2, capacity: int = 8, fps: int = 60,
             canonical_depth=None, device: DeviceLike = None) -> App:
    """Build the box_game App (pos/vel/handle columns, checksummed)."""
    app = App(
        num_players=num_players,
        capacity=capacity,
        fps=fps,
        input_shape=(),
        input_dtype=np.uint8,
        canonical_depth=canonical_depth,
        device=device,
    )
    app.rollback_component("pos", (2,), torch.float32, checksum=True)
    app.rollback_component("vel", (2,), torch.float32, checksum=True)
    app.rollback_component("handle", (), torch.int32, checksum=True)
    app.set_step(step)
    app.set_setup(setup(app))
    return app


def keys_to_input(up=False, down=False, left=False, right=False) -> np.uint8:
    """Keyboard -> BoxInput bitmask."""
    v = 0
    if up:
        v |= INPUT_UP
    if down:
        v |= INPUT_DOWN
    if left:
        v |= INPUT_LEFT
    if right:
        v |= INPUT_RIGHT
    return np.uint8(v)
