"""stress_soa — the benchmark workload with per-coordinate scalar columns.

Port of ``bevy_ggrs_tpu/models/stress_soa.py``: positions and velocities
under gravity with bounces, each coordinate its own ``[N]`` float32 column
(x/y/z/vx/vy/vz).  The arithmetic runs op by op with the JAX package's
float32 constants; ``x + vx * dt`` rounds twice, as numpy does (XLA on the
CPU contracts it into one FMA, so the two packages' states differ in the
last bits; see PERF.md).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..app import App
from ..snapshot.strategy import CopyStrategy, Strategy
from ..snapshot.world import active_mask, spawn_many
from ..utils.device import DeviceLike

GRAVITY = np.float32(-9.8)
BOUND = np.float32(50.0)

_COLS = ("x", "y", "z", "vx", "vy", "vz")


def step(world, ctx):
    """Gravity, integration and bounces over the scalar columns."""
    m = active_mask(world)
    dt = ctx.delta_seconds
    c = world.comps
    vy = c["vy"] + GRAVITY * dt  # float32 scalar product, as in JAX
    new = {
        "vx": c["vx"], "vy": vy, "vz": c["vz"],
        "x": c["x"] + c["vx"] * dt,
        "y": c["y"] + vy * dt,
        "z": c["z"] + c["vz"] * dt,
    }
    for p, v in (("x", "vx"), ("y", "vy"), ("z", "vz")):
        over = torch.abs(new[p]) > BOUND
        new[v] = torch.where(over, -new[v], new[v])
        new[p] = torch.clamp(new[p], -BOUND, BOUND)
    return dataclasses.replace(
        world, comps={k: torch.where(m, new[k], c[k]) for k in _COLS}
    )


def make_app(n_entities: int = 10_000, capacity: int | None = None,
             fps: int = 60, checksum: bool = True, seed: int = 0,
             canonical_depth: int | None = None,
             device: DeviceLike = None, strategy: Strategy = CopyStrategy) -> App:
    """Build the scalar-column benchmark App with n_entities pre-spawned
    (positions and velocities drawn from ``numpy.random.default_rng(seed)``,
    the same draws as the JAX package's setup).  ``strategy`` is every
    column's snapshot strategy (``QuantizeStrategy()`` keeps the ring in
    bf16)."""
    capacity = capacity or n_entities
    app = App(num_players=2, capacity=capacity, fps=fps,
              input_shape=(), input_dtype=np.uint8,
              canonical_depth=canonical_depth, device=device)
    for name in _COLS:
        app.rollback_component(name, (), torch.float32, checksum=checksum,
                               strategy=strategy)
    app.set_step(step)

    def setup(world):
        rng = np.random.default_rng(seed)
        cols = {}
        for name in ("x", "y", "z"):
            cols[name] = rng.uniform(-40, 40, n_entities).astype(np.float32)
        for name in ("vx", "vy", "vz"):
            cols[name] = rng.uniform(-5, 5, n_entities).astype(np.float32)
        return spawn_many(app.reg, world, cols, count=n_entities)

    app.set_setup(setup)
    return app
