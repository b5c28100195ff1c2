"""crowd — large-scale flocking, the model with cross-entity reductions.

Port of ``bevy_ggrs_tpu/models/crowd.py``: each member steers toward its
team's centroid and away from the global center of mass, and each player's
input steers its whole team.  The team centroids are a one-hot product
(``onehot.T @ pos``, a plain ``torch.matmul``, as the JAX package leaves
it to XLA) and the center of mass a sum over all entities.  The one-hot is
a compare against an ``arange`` (it batches under ``torch.func.vmap``,
so a wave of crowd lobbies runs with no fallback).

Float sums round in the order each library picks, so the port's states
differ from XLA's in the last bits, and the flocking feedback amplifies
such a difference over a long run: the tests hold one step at a time from
equal states.  Within the port, eager torch runs the same kernels at every
rollback depth, so SyncTest is clean.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..app import App
from ..snapshot.world import WorldState, active_mask, spawn_many
from ..utils.device import DeviceLike

COHESION = np.float32(0.4)
REPULSION = np.float32(0.15)
STEER = np.float32(2.0)
DRAG = np.float32(0.98)
BOUND = np.float32(30.0)


def make_step(app: App, num_teams: int):
    """Build the flocking step (team centroids via a one-hot product)."""

    def step(world: WorldState, ctx) -> WorldState:
        m = active_mask(world) & world.has["team"]
        mf = m.to(torch.float32)
        pos, vel = world.comps["pos"], world.comps["vel"]
        team = torch.clamp(world.comps["team"], 0, num_teams - 1)
        teams = torch.arange(num_teams, dtype=team.dtype, device=pos.device)
        onehot = (team[:, None] == teams).to(torch.float32) * mf[:, None]
        team_sum = torch.matmul(onehot.transpose(0, 1), pos)  # [T, 2]
        team_cnt = torch.clamp_min(onehot.sum(dim=0), 1.0)  # [T]
        centroids = team_sum / team_cnt[:, None]

        total = torch.clamp_min(mf.sum(), 1.0)
        com = (pos * mf[:, None]).sum(dim=0) / total

        n_inputs = ctx.inputs.shape[0]
        inp = ctx.inputs.reshape(-1)[torch.clamp(team, 0, n_inputs - 1).long()]
        inp = torch.where(m, inp, 0).to(torch.int32)

        def bit(b):
            return (torch.bitwise_right_shift(inp, b) & 1).to(torch.float32)

        steer = torch.stack([bit(3) - bit(2), bit(1) - bit(0)], dim=-1) * STEER
        to_centroid = centroids[team.long()] - pos
        from_com = pos - com[None, :]
        acc = COHESION * to_centroid + REPULSION * from_com + steer
        dt = ctx.delta_seconds
        vel = (vel + acc * dt) * DRAG
        pos = torch.clamp(pos + vel * dt, -BOUND, BOUND)

        m2 = m[:, None]
        return dataclasses.replace(world, comps={
            **world.comps,
            "pos": torch.where(m2, pos, world.comps["pos"]),
            "vel": torch.where(m2, vel, world.comps["vel"]),
        })

    return step


def make_app(n_per_team: int = 512, num_teams: int = 2, capacity: int | None = None,
             fps: int = 60, seed: int = 0, device: DeviceLike = None) -> App:
    """Build the crowd App: ``n_per_team`` boids per player-controlled team,
    their positions drawn from ``numpy.random.default_rng(seed)`` on the
    host (the JAX package's draws)."""
    n = n_per_team * num_teams
    capacity = capacity or n
    app = App(num_players=num_teams, capacity=capacity, fps=fps, input_shape=(),
              input_dtype=np.uint8, seed=seed, device=device)
    app.rollback_component("pos", (2,), torch.float32, checksum=True)
    app.rollback_component("vel", (2,), torch.float32, checksum=True)
    app.rollback_component("team", (), torch.int32, checksum=True)
    app.set_step(make_step(app, num_teams))

    def setup(world):
        rng = np.random.default_rng(seed)
        pos = rng.uniform(-20, 20, (n, 2)).astype(np.float32)
        team = np.repeat(np.arange(num_teams, dtype=np.int32), n_per_team)
        return spawn_many(app.reg, world, {
            "pos": pos, "vel": np.zeros((n, 2), np.float32), "team": team,
        }, count=n)

    app.set_setup(setup)
    return app
