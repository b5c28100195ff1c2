#!/usr/bin/env python
"""Multi-device crowd demo on the port (the twin of
``examples/crowd_multichip.py``): a flocking sim whose entity axis is
split over a ``(data x spec)`` mesh of ``torch.distributed`` ranks, with
speculative branches on the ``"spec"`` axis.  Runs on the card unless
``BGT_PLATFORM=cpu``.

One process (a one-rank group on its device):

    python examples_torch/crowd_multichip.py

One rank per card, under torchrun (``RANK`` and ``WORLD_SIZE`` set):

    torchrun --nproc-per-node 4 examples_torch/crowd_multichip.py

``--init-method file:///path`` rendezvouses through a shared file
instead of ``env://``'s TCP store.
"""

import argparse
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from bevy_ggrs_tpu_torch.utils.platform import apply_platform_env, device_label

DEVICE = apply_platform_env()

import numpy as np
import torch
import torch.distributed as dist

from bevy_ggrs_tpu_torch.models import crowd
from bevy_ggrs_tpu_torch.parallel import (
    make_mesh,
    make_sharded_resim_fn,
    make_sharded_speculate_fn,
)
from bevy_ggrs_tpu_torch.snapshot.checksum import checksum_to_int


def join_group(device_type: str, init_method: str) -> None:
    """Join the launcher's group when ``RANK``/``WORLD_SIZE`` are set (a
    CUDA rank takes card ``LOCAL_RANK``); otherwise ``make_mesh`` starts a
    one-rank group."""
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return
    if device_type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                            init_method=init_method, rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]))


def sync(device_type: str) -> None:
    if device_type == "cuda":
        torch.cuda.synchronize()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--per-team", type=int, default=4096)
    ap.add_argument("--teams", type=int, default=2)
    ap.add_argument("--frames", type=int, default=64)
    ap.add_argument("--branches", type=int, default=4)
    ap.add_argument("--spec-axis", type=int, default=2)
    ap.add_argument("--init-method", default="env://")
    args = ap.parse_args()

    device_type = torch.device(DEVICE).type
    join_group(device_type, args.init_method)
    world = dist.get_world_size() if dist.is_initialized() else 1
    n_spec = args.spec_axis if world % args.spec_axis == 0 else 1
    mesh = make_mesh(n_data=world // n_spec, n_spec=n_spec, devices=device_type)
    rank = dist.get_rank()
    dev = torch.device("cuda", torch.cuda.current_device()) if device_type == "cuda" \
        else torch.device("cpu")
    shape = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    print(f"rank {rank}: device: {device_label(dev)}, ranks: {world}, mesh {shape}",
          flush=True)

    app = crowd.make_app(n_per_team=args.per_team, num_teams=args.teams, device=dev)
    w0 = app.init_state()
    k = 8
    inputs = np.zeros((k, args.teams), np.uint8)
    status = np.zeros((k, args.teams), np.int8)

    resim = make_sharded_resim_fn(app, mesh)
    resim(w0, inputs, status, 0)  # warm-up
    sync(device_type)
    t0 = time.perf_counter()
    steps = max(args.frames // k, 1)
    w = w0
    for i in range(steps):
        w, _stacked, checks = resim(w, inputs, status, i * k)
    sync(device_type)
    dt = time.perf_counter() - t0
    n = args.per_team * args.teams
    print(f"rank {rank}: sharded resim: {steps * k} frames x {n} boids in {dt:.2f}s "
          f"({steps * k / dt:.0f} fps), checksum {checksum_to_int(checks[-1]):#x}",
          flush=True)

    branches = args.branches - args.branches % n_spec or n_spec
    spec = make_sharded_speculate_fn(app, mesh)
    bi = np.zeros((branches, k, args.teams), np.uint8)
    for b in range(branches):
        bi[b, :, :] = b  # distinct steering per branch
    bs = np.zeros((branches, k, args.teams), np.int8)
    spec(w0, bi, bs, 0)  # warm-up
    sync(device_type)
    t0 = time.perf_counter()
    _finals, _stacked, checks = spec(w0, bi, bs, 0)
    sync(device_type)
    dt = time.perf_counter() - t0
    print(f"rank {rank}: speculative fan-out: {branches} branches x {k} frames in "
          f"{dt * 1e3:.0f} ms ({branches * k / dt:.0f} resim-fps)", flush=True)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
