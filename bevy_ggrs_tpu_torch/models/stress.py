"""stress — N pre-spawned entities with ``[N, 3]`` position and velocity
columns, integrated under gravity with arena bounces.

Port of ``bevy_ggrs_tpu/models/stress.py`` (the vector-column twin of
:mod:`.stress_soa`).  The arithmetic runs op by op with the JAX package's
float32 constants; ``pos + vel * dt`` rounds twice, as numpy does (XLA on
the CPU contracts it into one FMA, so the two packages' states differ in
the last bits; see PERF.md).  The gravity vector is a device constant made
once per app, so a step uploads nothing.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import numpy as np
import torch

from ..app import App
from ..snapshot.world import active_mask, spawn_many
from ..utils.device import DeviceLike

GRAVITY = np.float32(-9.8)
BOUND = np.float32(50.0)


def gravity_vector(device) -> torch.Tensor:
    """``[0, GRAVITY, 0]`` as a float32 tensor on ``device``."""
    return torch.tensor([0.0, GRAVITY, 0.0], dtype=torch.float32, device=device)


def step(world, ctx, gravity: torch.Tensor = None):
    """Gravity integration with elastic arena bounces (``[N, 3]`` columns).

    ``gravity`` is :func:`gravity_vector` on the world's device; an app
    built by :func:`make_app` binds it once."""
    if gravity is None:
        gravity = gravity_vector(world.device)
    m = active_mask(world)[:, None]
    vel = world.comps["vel"] + gravity * ctx.delta_seconds
    pos = world.comps["pos"] + vel * ctx.delta_seconds
    # elastic bounce at the arena bounds
    over = torch.abs(pos) > BOUND
    vel = torch.where(over, -vel, vel)
    pos = torch.clamp(pos, -BOUND, BOUND)
    return dataclasses.replace(
        world,
        comps={
            "pos": torch.where(m, pos, world.comps["pos"]),
            "vel": torch.where(m, vel, world.comps["vel"]),
        },
    )


def make_app(n_entities: int = 10_000, capacity: int | None = None, fps: int = 60,
             checksum: bool = True, seed: int = 0, num_players: int = 2,
             canonical_depth: int | None = None,
             device: DeviceLike = None) -> App:
    """Build the stress App with n_entities pre-spawned (positions and
    velocities drawn from ``numpy.random.default_rng(seed)``, the same
    draws as the JAX package's setup)."""
    capacity = capacity or n_entities
    app = App(num_players=num_players, capacity=capacity, fps=fps,
              input_shape=(), input_dtype=np.uint8,
              canonical_depth=canonical_depth, device=device)
    app.rollback_component("pos", (3,), torch.float32, checksum=checksum)
    app.rollback_component("vel", (3,), torch.float32, checksum=checksum)
    app.set_step(partial(step, gravity=gravity_vector(app.device)))

    def setup(world):
        rng = np.random.default_rng(seed)
        pos = rng.uniform(-40, 40, (n_entities, 3)).astype(np.float32)
        vel = rng.uniform(-5, 5, (n_entities, 3)).astype(np.float32)
        return spawn_many(app.reg, world, {"pos": pos, "vel": vel}, count=n_entities)

    app.set_setup(setup)
    return app
