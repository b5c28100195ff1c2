"""particles — the stress-test / benchmark workload.

Port of ``bevy_ggrs_tpu/models/particles.py`` (the reference's particles
stress test): every frame decays each particle's ``ttl`` and despawns the
expired ones, integrates gravity, and spawns a burst of ``rate`` particles
with random velocity and height.  The randomness is rollback state: a
uint32 ``rng_counter`` resource keys each frame's draws as
``fold_in(PRNGKey(seed), rng_counter)``, split in two, one half per
``uniform`` draw, so a resimulated frame spawns exactly the particles the
live pass spawned.  The draws are ``utils/threefry.py``, bit for bit
``jax.random``'s, and ``spawn_many`` fills the first free slots in row
order, so the spawned values, slots and ids equal the JAX package's; the
integrated floats differ from it in the last bits where XLA fuses an FMA.

The step reads no host value of the device state, so it runs on the solo
path, under ``torch.func.vmap`` on the lane axis, and inside the megastep
program alike.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..app import App
from ..snapshot.strategy import CopyStrategy, QuantizeStrategy
from ..snapshot.world import WorldState, active_mask, despawn_where, spawn_many
from ..utils import threefry
from ..utils.device import DeviceLike

GRAVITY = np.float32(-9.8)
DEFAULT_TTL = 120  # frames (2 s at 60 fps)


def make_step(app: App, rate: int, ttl: int = DEFAULT_TTL):
    """Build the particles step: ttl decay, gravity, seeded spawn bursts."""
    reg = app.reg

    def step(world: WorldState, ctx) -> WorldState:
        dev = world.device
        m = active_mask(world) & world.has["ttl"]
        ttl_col = world.comps["ttl"]
        new_ttl = torch.where(m, ttl_col - 1, ttl_col)
        world = dataclasses.replace(world, comps={**world.comps, "ttl": new_ttl})
        world = despawn_where(reg, world, m & (new_ttl <= 0), ctx.frame)

        # integrate: the gravity row is the JAX package's [0, g, 0] * dt
        dt = ctx.delta_seconds
        m3 = (active_mask(world) & world.has["vel"])[:, None]
        # made on the card (a setitem of a host scalar would copy it there)
        gvec = torch.where(torch.arange(3, device=dev) == 1, float(GRAVITY * dt), 0.0)
        vel = world.comps["vel"] + gvec
        pos = world.comps["pos"] + vel * dt
        world = dataclasses.replace(world, comps={
            **world.comps,
            "vel": torch.where(m3, vel, world.comps["vel"]),
            "pos": torch.where(m3, pos, world.comps["pos"]),
        })

        # the spawn burst, keyed by the rollback counter
        counter = world.res["rng_counter"]
        kv, kp = threefry.split(threefry.fold_in(threefry.prng_key(app.seed), counter))
        new_vel = threefry.uniform(kv, (rate, 3), -2.0, 2.0)
        y = threefry.uniform(kp, (rate,))
        zeros = torch.zeros_like(y)
        world = spawn_many(reg, world, {
            "pos": torch.stack([zeros, y, zeros], dim=-1),
            "vel": new_vel,
            "ttl": torch.full((rate,), ttl, dtype=torch.int32, device=dev),
        }, count=rate)
        bumped = (counter.view(torch.int32) + 1).view(torch.uint32)  # wraps as u32
        return dataclasses.replace(world, res={**world.res, "rng_counter": bumped})

    return step


def make_app(
    rate: int = 100,
    ttl: int = DEFAULT_TTL,
    capacity: int | None = None,
    num_players: int = 2,
    fps: int = 60,
    checksum: bool = True,
    seed: int = 0,
    quantize: bool = False,
    device: DeviceLike = None,
) -> App:
    """Build the particles App (capacity sized for ``rate`` x ``ttl``).

    ``quantize`` stores the float columns' ring snapshots in bf16
    (``QuantizeStrategy``), the reference's ``--reflect`` strategy knob."""
    if capacity is None:
        capacity = rate * (ttl + 8) + 64  # steady state + rollback headroom
    app = App(num_players=num_players, capacity=capacity, fps=fps, input_shape=(),
              input_dtype=np.uint8, seed=seed, device=device)
    strat = QuantizeStrategy(torch.bfloat16) if quantize else CopyStrategy
    app.rollback_component("pos", (3,), torch.float32, checksum=checksum, strategy=strat)
    app.rollback_component("vel", (3,), torch.float32, checksum=checksum, strategy=strat)
    app.rollback_component("ttl", (), torch.int32, checksum=checksum)
    app.rollback_resource("rng_counter", np.uint32(0), checksum=checksum)
    app.set_step(make_step(app, rate, ttl))
    return app
