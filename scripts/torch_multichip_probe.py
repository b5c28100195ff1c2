#!/usr/bin/env python
"""Multi-device probe of the port on every visible card: the two axes of
``bevy_ggrs_tpu_torch/parallel`` across real cards, each against its
one-card counterpart.

1. The lobby axis, in this process: k-frame packed waves of ``--lobbies``
   ``stress_soa`` worlds of ``--entities`` through the unsharded executor
   on card 0, through ``ShardedWaveExecutor`` over D logical shards of
   card 0, and over the D cards (``make_lobby_mesh()``).  Every lane of
   both sharded arms must equal the unsharded wave's bit for bit; then
   lobby-frames/s of the three arms in turns over ``--pairs`` rounds of
   ``--iters`` chained waves (median and spread).
2. The entity axis: one NCCL rank per card (spawned here, meeting through
   a ``FileStore`` in a temporary directory): ``make_mesh(D, 1)`` and the
   sharded resim of a ``stress_soa`` world of ``--world-entities`` at
   k=``--k``, whose final state, stack and checksums must equal each
   rank's own one-card resim of the whole world bit for bit; ms per call
   sharded against one-card (median of ``--reps``).

    python scripts/torch_multichip_probe.py            # every visible card
    python scripts/torch_multichip_probe.py --cards 2

Prints one JSON line per part (with the card's name and power limit) and
exits nonzero on any mismatch.  Needs at least two cards.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from datetime import timedelta
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np
import torch


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]


def sync_all(n: int) -> None:
    for d in range(n):
        torch.cuda.synchronize(d)


def trees_equal(a, b) -> bool:
    from bevy_ggrs_tpu_torch.utils.tree import tree_flatten

    return all(torch.equal(x, y) for x, y in zip(tree_flatten(a), tree_flatten(b),
                                                  strict=True))


def lobby_axis(args, cards: int) -> dict:
    from bevy_ggrs_tpu_torch import BucketedWaveExecutor, stack_worlds
    from bevy_ggrs_tpu_torch.models import stress_soa
    from bevy_ggrs_tpu_torch.ops.batch import ShardedWaveExecutor
    from bevy_ggrs_tpu_torch.ops.packing import pack_prefix, pack_row
    from bevy_ggrs_tpu_torch.parallel import make_lobby_mesh
    from bevy_ggrs_tpu_torch.snapshot.lazy import BatchChecks

    dev0 = torch.device("cuda", 0)
    m, k = args.lobbies, args.k
    app = stress_soa.make_app(n_entities=args.entities, device=dev0)
    spec = app.packed_spec
    buf = spec.new_batch_buffer(m, k)
    rng = np.random.default_rng(5)
    for b in range(m):
        pack_prefix(buf[b], b * 7, k)
        for i in range(k):
            pack_row(spec, buf[b], i, rng.integers(0, 16, 2).astype(np.uint8),
                     np.zeros(2, np.int8))
    worlds = stack_worlds([app.init_state()] * m)
    ks = [k] * m
    arms = {
        "unsharded": BucketedWaveExecutor(app, k),
        "logical_shards": ShardedWaveExecutor(app, k, make_lobby_mesh(devices=[dev0] * cards)),
        "cards": ShardedWaveExecutor(app, k, make_lobby_mesh(n_devices=cards)),
    }
    _, rf, rs, rc = arms["unsharded"].run_wave_packed(worlds, buf, ks)
    for name in ("logical_shards", "cards"):
        _, sf, ss, sc = arms[name].run_wave_packed(worlds, buf, ks)
        if not (trees_equal(sf.gather(dev0), rf) and trees_equal(ss.gather(dev0), rs)
                and BatchChecks(sc).host() == rc.tolist()):
            raise SystemExit(f"multichip probe: {name} lanes differ from the unsharded wave")
    del rf, rs, rc
    state = {name: worlds for name in arms}
    rates = {name: [] for name in arms}
    for _ in range(args.pairs):
        for name, ex in arms.items():
            sync_all(cards)
            t0 = time.perf_counter()
            for _ in range(args.iters):
                _, state[name], _, _ = ex.run_wave_packed(state[name], buf, ks)
            sync_all(cards)
            rates[name].append(args.iters * m * k / (time.perf_counter() - t0))
    out = {"part": "lobby_axis", "cards": cards, "lobbies": m, "entities": args.entities,
           "k": k, "lanes_bit_equal": True,
           "census": arms["cards"].harvest_shards(
               arms["cards"].run_wave_packed(worlds, buf, ks)[1:])}
    for name, r in rates.items():
        out[f"{name}_lobby_frames_per_s"] = {"median": statistics.median(r), "min": min(r),
                                             "max": max(r)}
    return out


def entity_rank(rank: int, world: int, store: str, args, queue) -> None:
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from bevy_ggrs_tpu_torch.models import stress_soa
    from bevy_ggrs_tpu_torch.parallel import make_mesh, make_sharded_resim_fn
    from bevy_ggrs_tpu_torch.utils.tree import tree_map

    torch.cuda.set_device(rank)
    dist.init_process_group("nccl", store=dist.FileStore(store, world), rank=rank,
                            world_size=world, timeout=timedelta(seconds=120))
    try:
        dev = torch.device("cuda", rank)
        mesh = make_mesh(world, 1)
        app = stress_soa.make_app(n_entities=args.world_entities, device=dev)
        w = app.init_state()
        rng = np.random.default_rng(3)
        inputs = torch.as_tensor(rng.integers(0, 16, (args.k, 2)).astype(np.uint8)).to(dev)
        status = torch.zeros((args.k, 2), dtype=torch.int8, device=dev)
        want = app.resim_fn(w, inputs, status, 0)
        sharded = make_sharded_resim_fn(app, mesh)
        got = sharded(w, inputs, status, 0)
        full = tree_map(lambda a: a.full_tensor() if isinstance(a, DTensor) else a,
                        (got[0], got[1]))
        equal = trees_equal(full, (want[0], want[1])) and torch.equal(got[2], want[2])
        local_rows = got[0].alive.to_local().shape[0]
        del got, full, want

        def timed(fn) -> float:
            times = []
            for _ in range(args.reps):
                dist.barrier()
                torch.cuda.synchronize(dev)
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize(dev)
                times.append((time.perf_counter() - t0) * 1e3)
            return statistics.median(times)

        plain_ms = timed(lambda: app.resim_fn(w, inputs, status, 0))
        sharded_ms = timed(lambda: sharded(w, inputs, status, 0))
        queue.put({"rank": rank, "bit_equal": equal, "local_rows": local_rows,
                   "plain_ms": plain_ms, "sharded_ms": sharded_ms})
    finally:
        dist.destroy_process_group()


def entity_axis(args, cards: int) -> dict:
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=entity_rank, args=(r, cards, os.path.join(tmp, "store"),
                                                       args, queue)) for r in range(cards)]
        for p in procs:
            p.start()
        results = []
        try:
            for _ in range(cards):
                results.append(queue.get(timeout=args.rank_timeout))
        finally:
            for p in procs:
                p.join(timeout=30)
                if p.is_alive():
                    p.kill()
    results.sort(key=lambda r: r["rank"])
    if not all(r["bit_equal"] for r in results):
        raise SystemExit(f"multichip probe: the sharded resim differs: {results}")
    return {"part": "entity_axis", "cards": cards, "entities": args.world_entities,
            "k": args.k, "ranks": results,
            "plain_ms_median": statistics.median(r["plain_ms"] for r in results),
            "sharded_ms_median": statistics.median(r["sharded_ms"] for r in results)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cards", type=int, default=None)
    ap.add_argument("--lobbies", type=int, default=64)
    ap.add_argument("--entities", type=int, default=65_536)
    ap.add_argument("--world-entities", type=int, default=4_000_000)
    ap.add_argument("--k", type=int, default=8)
    ap.add_argument("--pairs", type=int, default=5)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--rank-timeout", type=float, default=300.0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("multichip probe: no CUDA device", file=sys.stderr)
        return 1
    cards = args.cards or torch.cuda.device_count()
    if cards < 2 or cards > torch.cuda.device_count():
        print(f"multichip probe: needs 2 to {torch.cuda.device_count()} cards, "
              f"got {cards}", file=sys.stderr)
        return 1
    card = card_line()
    for part in (lobby_axis, entity_axis):
        t0 = time.perf_counter()
        out = part(args, cards)
        print(json.dumps({**out, "card": card, "seconds": time.perf_counter() - t0}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
