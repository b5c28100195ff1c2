"""pong — a complete two-player game on the framework.

Port of ``bevy_ggrs_tpu/models/pong.py``: paddle entities driven by
inputs, a ball that despawns on a goal and respawns after a serve delay
(deferred despawn, and a spawn whose count is a device value), a score
resource and a win condition, all rollback-safe and checksummed.  Input
bits: UP=1, DOWN=2.

The step compares ``ctx.frame`` on the device.  On the solo path the frame
is a host int, on the lane path a device scalar; the step turns a host
frame into a device scalar with one fill and then runs the same tensor ops
on both, with no Python ``if`` on a tensor.  An app's step closes over
its own registry (:func:`make_step`), so two pong apps do not share one;
the module-level :func:`step` keeps the JAX package's contract and reads
the registry of the last :func:`make_app`, as the JAX ``_REG`` does.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..app import App
from ..snapshot.world import WorldState, active_mask, despawn_where, spawn, spawn_many
from ..utils.device import DeviceLike

UP, DOWN = 1, 2

COURT_W = np.float32(8.0)  # half-extent x
COURT_H = np.float32(4.5)  # half-extent y
PADDLE_X = np.float32(7.5)
PADDLE_HALF = np.float32(1.0)
PADDLE_SPEED = np.float32(6.0)
BALL_SPEED = np.float32(6.0)
SERVE_DELAY = 45  # frames between goal and re-serve
WIN_SCORE = 11

# entity kinds
K_PADDLE = 0
K_BALL = 1


def _frame_tensor(frame, device) -> torch.Tensor:
    """The step's frame as an int32 device scalar (a fill for a host int)."""
    if isinstance(frame, torch.Tensor):
        return frame.to(torch.int32)
    return torch.full((), frame, dtype=torch.int32, device=device)


def make_step(app: App):
    """Build the pong step of ``app``: paddles, ball, goals and the serve
    cycle, over ``app``'s registry."""
    reg = app.reg
    return lambda world, ctx: _step(reg, world, ctx)


def step(world: WorldState, ctx) -> WorldState:
    """Paddles + ball + goals + serve cycle over the registry of the last
    :func:`make_app` (the JAX package's module-level step)."""
    if _REG[0] is None:
        raise RuntimeError("pong.step needs a registry: call pong.make_app first")
    return _step(_REG[0], world, ctx)


_REG = [None]  # the registry of the last make_app, for the module-level step


def _step(reg, world: WorldState, ctx) -> WorldState:
    """One pong frame over ``reg`` (see module docstring)."""
    dev = world.device
    dt = ctx.delta_seconds
    m = active_mask(world)
    kind = world.comps["kind"]
    owner = world.comps["owner"]
    pos = world.comps["pos"]
    vel = world.comps["vel"]

    is_paddle = m & (kind == K_PADDLE)
    is_ball = m & (kind == K_BALL)

    # paddles: input-driven vertical movement
    n_inputs = ctx.inputs.shape[0]
    inp = ctx.inputs.reshape(-1)[torch.clamp(owner, 0, n_inputs - 1).long()]
    inp = torch.where(is_paddle, inp, 0).to(torch.int32)
    dy = ((inp & 1) - (torch.bitwise_right_shift(inp, 1) & 1)).to(torch.float32) * PADDLE_SPEED
    pad_y = torch.clamp(pos[:, 1] + dy * dt, -COURT_H + PADDLE_HALF,
                        COURT_H - PADDLE_HALF)
    pos = torch.stack([pos[:, 0], torch.where(is_paddle, pad_y, pos[:, 1])], dim=-1)

    # ball: integrate, bounce off the walls and the paddles
    bpos = pos + vel * dt
    hit_wall = torch.abs(bpos[:, 1]) > COURT_H
    bvx, bvy = vel[:, 0], torch.where(hit_wall, -vel[:, 1], vel[:, 1])
    bx, by = bpos[:, 0], torch.clamp(bpos[:, 1], -COURT_H, COURT_H)
    p0y = torch.where(is_paddle & (owner == 0), pos[:, 1], 0.0).sum()
    p1y = torch.where(is_paddle & (owner == 1), pos[:, 1], 0.0).sum()
    near_p0 = (bx < -PADDLE_X) & (torch.abs(by - p0y) <= PADDLE_HALF)
    near_p1 = (bx > PADDLE_X) & (torch.abs(by - p1y) <= PADDLE_HALF)
    bounce = (near_p0 & (bvx < 0)) | (near_p1 & (bvx > 0))
    bvx = torch.where(bounce, -bvx * np.float32(1.05), bvx)
    bx = torch.where(bounce, torch.clamp(bx, -PADDLE_X, PADDLE_X), bx)

    ball = is_ball[:, None]
    pos = torch.where(ball, torch.stack([bx, by], dim=-1), pos)
    vel = torch.where(ball, torch.stack([bvx, bvy], dim=-1), vel)

    # goals: a ball fully past a goal line (and not bounced)
    goal_p1 = is_ball & (pos[:, 0] <= -COURT_W)  # player 1 scores
    goal_p0 = is_ball & (pos[:, 0] >= COURT_W)  # player 0 scores
    scored_any = goal_p0.any() | goal_p1.any()
    score = world.res["score"] + torch.stack(
        [goal_p0.sum(), goal_p1.sum()]).to(torch.int32)
    frame = _frame_tensor(ctx.frame, dev)
    world = dataclasses.replace(world, comps={**world.comps, "pos": pos, "vel": vel},
                                res={**world.res, "score": score})
    world = despawn_where(reg, world, goal_p0 | goal_p1, frame)

    # serve: respawn the ball after the delay (deterministic direction)
    serve_at = torch.where(scored_any, frame + SERVE_DELAY,
                           world.res["serve_at"]).to(torch.int32)
    game_over = (score[0] >= WIN_SCORE) | (score[1] >= WIN_SCORE)
    do_serve = (serve_at == frame) & ~game_over
    direction = torch.where((score[0] + score[1]) % 2 == 0, 1.0, -1.0)
    tilt = torch.where(frame % 3 == 0, 0.35, -0.5).to(torch.float32)
    new_ball = {
        "pos": torch.zeros((1, 2), dtype=torch.float32, device=dev),
        "vel": torch.stack([direction * BALL_SPEED, tilt * BALL_SPEED]
                           ).to(torch.float32)[None],
        "kind": torch.full((1,), K_BALL, dtype=torch.int32, device=dev),
        "owner": torch.full((1,), -1, dtype=torch.int32, device=dev),
    }
    world = spawn_many(reg, world, new_ball, count=do_serve.to(torch.int32))
    return dataclasses.replace(world, res={**world.res, "serve_at": serve_at})


def make_app(fps: int = 60, capacity: int = 16, canonical_depth=None,
             device: DeviceLike = None) -> App:
    """Build the pong App (paddle entities, score/serve resources)."""
    app = App(num_players=2, capacity=capacity, fps=fps, input_shape=(),
              input_dtype=np.uint8, canonical_depth=canonical_depth, device=device)
    app.rollback_component("pos", (2,), torch.float32, checksum=True)
    app.rollback_component("vel", (2,), torch.float32, checksum=True)
    app.rollback_component("kind", (), torch.int32, checksum=True)
    app.rollback_component("owner", (), torch.int32, checksum=True)
    app.rollback_resource("score", np.zeros(2, np.int32), checksum=True)
    app.rollback_resource("serve_at", np.int32(1), checksum=True)
    _REG[0] = app.reg
    app.set_step(make_step(app))

    def setup(world):
        for h in range(2):
            world, _ = spawn(app.reg, world, {
                "pos": np.array([(-1 if h == 0 else 1) * PADDLE_X, 0.0], np.float32),
                "vel": np.zeros(2, np.float32), "kind": K_PADDLE, "owner": h,
            })
        return world

    app.set_setup(setup)
    return app


def winner(world) -> int:
    """-1 while playing, else the winning handle."""
    s = world.res["score"].cpu().numpy()
    if s[0] >= WIN_SCORE:
        return 0
    if s[1] >= WIN_SCORE:
        return 1
    return -1
