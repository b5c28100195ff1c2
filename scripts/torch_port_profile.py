#!/usr/bin/env python
"""Where the PyTorch port's time goes on the card, from torch.profiler
traces.  Its modes:

- default: ``App.resim_fn`` on ``stress_soa`` (k=8).  Prints one JSON line:
  wall ms per resim call (host clock around calls that end in a
  synchronize), device-busy ms per call (the sum of the CUDA kernels' self
  time in the trace; kernels of one stream do not overlap), the idle share
  of the profiled calls (a busy time beyond their wall time fails),
  the kernel launches per call and the wall time per launch, and the top
  kernels by device time with their calls.
- ``--p2p``: a P2P tick of a ``stress_soa`` pair, as ``chip_smoke.py``
  phases ``p2p`` and ``pipeline`` drive it (two runners with
  ``P2PSession``s over a ``ChannelNetwork``, 3 hops, no loss; input delay
  1, prediction window 8, checksums compared every frame; peer 0's input
  flips every 7 frames, so peer 1 rolls back).  ``--mode`` picks the
  runner's dispatch mode: ``pipelined`` (its defaults: pipelined, packed,
  donating) or ``sync`` (``pipeline=False, packed=False``).  Prints one
  JSON line: host ms per peer tick over ``P2P_TICKS`` ticks, split into
  the network poll, the session step (inputs and ``advance_frame``), the
  resim calls, the rest of request handling (staging, ring and save
  cells) and the rest of the tick (the harvest, and in the sync mode the
  end-of-tick wait for the card); then, from a trace of
  ``PROFILE_TICKS`` ticks, the device-busy ms per tick, the idle share,
  the kernel launches per tick, and the host-to-device copies per tick
  (from pinned and from pageable memory) and device-to-host copies.
- ``--service``: the rollback service time of a hedging pair, split by
  the ring's memory guard.  The JAX bench's speculation-service traffic
  as ``chip_smoke.py`` phase ``speculation`` drives it (``stress_soa`` at
  65,536 entities unless ``--entities`` says otherwise, 6 hops, input
  delay 1, inputs flipping every 7 ticks, checksums compared every frame;
  both peers hedge both pads over {0, 1} at depth 8, 16 cached frames,
  ``measure_rollback_service=True``).  The pair runs ``SERVICE_TICKS``
  timed ticks with the runner's guard (``ring_materialize_bytes``) at its
  64 MiB default and raised above any cache entry, in turns (default,
  raised, raised, default), each on a fresh pair.  Prints one JSON line:
  per run, the hit and miss service ms (p50, p99), the hits, the
  cache-served frames, the saves cloned out per hit and the pair's peak
  device memory (``torch.cuda.max_memory_allocated`` over the run: views
  of served saves pin their cache entries while they are ringed).

- ``--server``: a many-lobby server tick, as ``chip_smoke.py`` phase
  ``batched`` part (c) drives it (8 P2P pairs, 16 lobbies of
  ``stress_soa`` at 10,000 entities unless ``--entities`` says otherwise,
  in one ``BatchedRunner``; the pairs, their channel and inputs come from
  ``chip_smoke.py``).  Prints one JSON line: host ms per server tick over
  ``P2P_TICKS`` ticks, split into the lobbies' network polls, their
  session steps, the load waves, the run waves' executor calls, the rest
  of the run waves (staging and saves) and the rest of the tick; then,
  from a trace of ``PROFILE_TICKS`` ticks, the device-busy ms per tick,
  the idle share, kernel launches, copies per tick and the top kernels.

Needs a CUDA card; it fails without one.

Run from the repo root:
    python scripts/torch_port_profile.py [--entities N] [--p2p [--mode pipelined|sync]]
    python scripts/torch_port_profile.py --service [--entities N]
    python scripts/torch_port_profile.py --server [--entities N]
"""

import argparse
import gc
import json
import sys
import time
from collections import defaultdict

sys.path.insert(0, ".")

import numpy as np  # noqa: E402
import torch  # noqa: E402

P2P_TICKS = 240  # timed ticks per peer, as chip_smoke.py's p2p phase
PROFILE_TICKS = 60  # traced ticks per peer
WARMUP_TICKS = 30
FLIP_FRAMES = 7
MODES = {"pipelined": {}, "sync": {"pipeline": False, "packed": False}}
SERVICE_TICKS = 150  # timed ticks, as chip_smoke.py's speculation phase
SERVICE_WARMUP_TICKS = 60
RESIM_FNS = ("resim_fn", "resim_fn_donated", "packed_resim_fn", "packed_resim_fn_donated")


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def _device_events(prof) -> list:
    """The trace's kernels, copies and fills with device time, as
    ``key_averages()`` (a user annotation's device range spans the kernels
    inside it and would count them twice)."""
    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and _device_us(e) > 0
            and not getattr(e, "is_user_annotation", False)
            and not e.key.startswith("ProfilerStep")]


def _idle_share(busy_ms: float, wall_ms: float) -> float:
    """``1 - busy / wall``; a busy time beyond the wall time is a counting
    error, not an idle share, and raises."""
    if not 0 < busy_ms <= wall_ms:
        raise SystemExit(f"device busy {busy_ms} ms is not within the wall time {wall_ms} ms")
    return 1.0 - busy_ms / wall_ms


def profile_resim(entities: int, k: int, calls: int) -> dict:
    from torch.profiler import ProfilerActivity, profile

    from bevy_ggrs_tpu_torch.models import stress_soa

    app = stress_soa.make_app(n_entities=entities, device="cuda")
    world = app.init_state()
    inputs = torch.zeros((k, 2), dtype=torch.uint8, device="cuda")
    status = torch.zeros((k, 2), dtype=torch.int8, device="cuda")
    for _ in range(3):
        app.resim_fn(world, inputs, status, 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        app.resim_fn(world, inputs, status, 0)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / calls
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        for _ in range(calls):
            app.resim_fn(world, inputs, status, 0)
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t1) * 1e3 / calls
    kernels = _device_events(prof)
    busy_ms = sum(_device_us(e) for e in kernels) / 1e3 / calls
    launches = sum(e.count for e in kernels) / calls
    top = sorted(kernels, key=_device_us, reverse=True)[:15]
    return {
        "card": torch.cuda.get_device_name(0), "entities": entities,
        "k": k, "calls": calls, "wall_ms_per_call": wall_ms,
        "device_busy_ms_per_call": busy_ms,
        "wall_ms_per_call_profiled": prof_wall_ms,
        "idle_share": _idle_share(busy_ms, prof_wall_ms),
        "kernel_launches_per_call": launches,
        "wall_us_per_launch": wall_ms * 1e3 / launches if launches else None,
        "top_kernels": [{"name": e.key[:90], "ms_per_call": _device_us(e) / 1e3 / calls,
                         "calls_per_resim": e.count / calls} for e in top],
    }


def _p2p_pair(entities: int, mode: str):
    """Two stress_soa peers over a ChannelNetwork, synchronized."""
    from bevy_ggrs_tpu_torch import DesyncDetection, GgrsRunner, PlayerType, SessionBuilder
    from bevy_ggrs_tpu_torch.models import stress_soa
    from bevy_ggrs_tpu_torch.session.channel import ChannelNetwork

    net = ChannelNetwork(latency_hops=3, loss=0.0, seed=0)
    runners = []
    for i in range(2):
        app = stress_soa.make_app(n_entities=entities, device="cuda")
        session = (SessionBuilder.for_app(app).with_input_delay(1)
                   .with_max_prediction_window(8)
                   .with_desync_detection_mode(DesyncDetection.on(1))
                   .add_player(PlayerType.LOCAL, i)
                   .add_player(PlayerType.REMOTE, 1 - i, f"p{1 - i}")
                   .start_p2p_session(net.endpoint(f"p{i}")))

        def read_inputs(handles, i=i):  # peer 0 flips, peer 1 holds
            on = i == 1 or (runners[0].frame // FLIP_FRAMES) % 2 == 0
            return {h: np.uint8(8 if on else 1) for h in handles}

        runners.append(GgrsRunner(app, session, read_inputs=read_inputs, **MODES[mode]))
    for _ in range(5000):
        net.deliver()
        for r in runners:
            r.update(0.0)
        if all(r.session.current_state().value == "running" for r in runners):
            return net, runners
    raise SystemExit("torch_port_profile: the sessions never synchronized")


def _drive(net, runners, ticks: int) -> None:
    for _ in range(ticks):
        net.deliver()
        for r in runners:
            r.update(1.0 / 60.0)


def _timed(obj, name: str, acc: dict, key: str) -> None:
    """Replace ``obj.name`` by a wrapper that adds its host time to ``acc[key]``."""
    fn = getattr(obj, name)

    def wrapper(*args, **kw):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kw)
        finally:
            acc[key] += time.perf_counter() - t0

    setattr(obj, name, wrapper)


def profile_p2p(entities: int, mode: str) -> dict:
    from torch.profiler import ProfilerActivity, profile

    net, runners = _p2p_pair(entities, mode)
    _drive(net, runners, WARMUP_TICKS)
    acc = defaultdict(float)
    for r in runners:
        _timed(r.session, "poll_remote_clients", acc, "poll")
        _timed(r, "_step_session", acc, "session_step")
        _timed(r, "_handle_requests", acc, "handle_requests")
        for name in RESIM_FNS:
            if getattr(r.app, name) is not None:
                _timed(r.app, name, acc, "resim")
    frames0 = [r.frame for r in runners]
    rollbacks0 = [r.rollbacks for r in runners]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _drive(net, runners, P2P_TICKS)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    peer_frames = [r.frame - f for r, f in zip(runners, frames0)]
    rollbacks = [r.rollbacks - b for r, b in zip(runners, rollbacks0)]
    peer_ticks = 2 * P2P_TICKS
    host_ms = {k: v * 1e3 / peer_ticks for k, v in acc.items()}
    host_ms["requests_besides_resim"] = host_ms["handle_requests"] - host_ms["resim"]
    host_ms["tick"] = wall_s * 1e3 / peer_ticks
    # harvest, and in the sync mode the end-of-tick wait for the card
    host_ms["rest_of_tick"] = host_ms["tick"] - sum(
        host_ms[k] for k in ("poll", "session_step", "handle_requests"))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        _drive(net, runners, PROFILE_TICKS)
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t1) * 1e3
    busy_us, launches, htod, htod_pageable, dtoh = 0.0, 0, 0, 0, 0
    events = _device_events(prof)
    for e in events:
        busy_us += _device_us(e)
        if "Memcpy HtoD" in e.key:
            htod += e.count
            htod_pageable += e.count if "Pageable" in e.key else 0
        elif "Memcpy DtoH" in e.key:
            dtoh += e.count
        elif "Memcpy" not in e.key and "Memset" not in e.key:
            launches += e.count
    top = sorted(events, key=_device_us, reverse=True)[:8]
    n = 2 * PROFILE_TICKS
    return {
        "card": torch.cuda.get_device_name(0), "entities": entities, "mode": mode,
        "ticks": P2P_TICKS,
        "peer_frames": peer_frames, "rollbacks": rollbacks,
        "host_ms_per_peer_tick": host_ms,
        "profiled_peer_ticks": n, "wall_ms_per_peer_tick_profiled": prof_wall_ms / n,
        "device_busy_ms_per_peer_tick": busy_us / 1e3 / n,
        "idle_share": _idle_share(busy_us / 1e3 / n, prof_wall_ms / n),
        "kernel_launches_per_peer_tick": launches / n,
        "htod_copies_per_peer_tick": htod / n,
        "pageable_htod_copies_per_peer_tick": htod_pageable / n,
        "dtoh_copies_per_peer_tick": dtoh / n,
        "top_device_events": [{"name": e.key[:70], "ms_per_peer_tick": _device_us(e) / 1e3 / n,
                               "calls_per_peer_tick": e.count / n} for e in top],
    }


def _trace_counts(prof, n: int) -> dict:
    """Device busy ms, launches and copies per tick of a trace of ``n``
    ticks, and its top kernels."""
    busy_us, launches, htod, dtoh = 0.0, 0, 0, 0
    events = _device_events(prof)
    for e in events:
        busy_us += _device_us(e)
        if "Memcpy HtoD" in e.key:
            htod += e.count
        elif "Memcpy DtoH" in e.key:
            dtoh += e.count
        elif "Memcpy" not in e.key and "Memset" not in e.key:
            launches += e.count
    top = sorted(events, key=_device_us, reverse=True)[:8]
    return {"device_busy_ms_per_tick": busy_us / 1e3 / n, "kernel_launches_per_tick": launches / n,
            "htod_copies_per_tick": htod / n, "dtoh_copies_per_tick": dtoh / n,
            "top_device_events": [{"name": e.key[:70], "ms_per_tick": _device_us(e) / 1e3 / n,
                                   "calls_per_tick": e.count / n} for e in top]}


def profile_server(entities: int) -> dict:
    from torch.profiler import ProfilerActivity, profile

    from bevy_ggrs_tpu_torch import BatchedRunner
    from bevy_ggrs_tpu_torch.models import stress_soa
    from chip_smoke import SIZES, pair_inputs, pair_sessions, sync_all

    dev = torch.device("cuda")

    def make_app(_dev=None):
        return stress_soa.make_app(n_entities=entities, device=dev)

    nets, sessions = pair_sessions(make_app, dev, SIZES["server_pairs"], seed=40)
    br = BatchedRunner(make_app(), sessions,
                       read_inputs=lambda b, hs: {h: pair_inputs(br.frames[b], b) for h in hs})
    sync_all(nets, br.tick, sessions)

    def drive(ticks):
        for _ in range(ticks):
            for net in nets:
                net.deliver()
            br.tick()

    drive(WARMUP_TICKS)
    acc = defaultdict(float)
    for s in sessions:
        _timed(s, "poll_remote_clients", acc, "poll")
        _timed(s, "advance_frame", acc, "session_step")
    _timed(br, "_do_loads", acc, "loads")
    _timed(br, "_do_runs", acc, "runs")
    _timed(br.exec, "run_wave_packed", acc, "wave_calls")
    st0 = br.stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    drive(P2P_TICKS)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    st = br.stats()
    host_ms = {k: v * 1e3 / P2P_TICKS for k, v in acc.items()}
    host_ms["runs_besides_wave_calls"] = host_ms["runs"] - host_ms["wave_calls"]
    host_ms["tick"] = wall_s * 1e3 / P2P_TICKS
    host_ms["rest_of_tick"] = host_ms["tick"] - sum(
        host_ms[k] for k in ("poll", "session_step", "loads", "runs"))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        drive(PROFILE_TICKS)
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t1) * 1e3
    counts = _trace_counts(prof, PROFILE_TICKS)
    waves = st["wave_dispatches"] - st0["wave_dispatches"]
    return {"card": torch.cuda.get_device_name(0), "entities": entities,
            "lobbies": len(sessions), "ticks": P2P_TICKS,
            "lobby_frames": sum(st["frames"]) - sum(st0["frames"]),
            "rollbacks": st["rollbacks"] - st0["rollbacks"], "waves": waves,
            "host_ms_per_tick": host_ms, "host_ms_per_wave_call": host_ms["wave_calls"]
            * P2P_TICKS / waves,
            "wall_ms_per_tick_profiled": prof_wall_ms / PROFILE_TICKS,
            "idle_share": _idle_share(counts["device_busy_ms_per_tick"],
                                      prof_wall_ms / PROFILE_TICKS), **counts}


def service_run(entities: int, guard_bytes: int) -> dict:
    """One hedging pair on the speculation-service traffic with the ring
    guard at ``guard_bytes``: service ms by path and the clones per hit."""
    from bevy_ggrs_tpu_torch import (
        DesyncDetection,
        GgrsRunner,
        PlayerType,
        SessionBuilder,
        SpeculationConfig,
        pad_candidates,
    )
    from bevy_ggrs_tpu_torch.models import stress_soa
    from bevy_ggrs_tpu_torch.session.channel import ChannelNetwork
    from bevy_ggrs_tpu_torch.session.events import DesyncDetected

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    net = ChannelNetwork(seed=7, latency_hops=6)
    spec = SpeculationConfig(candidates_fn=pad_candidates(2, [0, 1], [0, 1]), depth=8,
                             max_cached_frames=16)
    runners = []
    for i in range(2):
        app = stress_soa.make_app(n_entities=entities, device="cuda")
        session = (SessionBuilder.for_app(app).with_input_delay(1)
                   .with_desync_detection_mode(DesyncDetection.on(1))
                   .add_player(PlayerType.LOCAL, i)
                   .add_player(PlayerType.REMOTE, 1 - i, f"s{1 - i}")
                   .start_p2p_session(net.endpoint(f"s{i}")))
        count = [0]

        def read_inputs(handles, count=count):
            count[0] += 1
            return {h: np.uint8((count[0] // FLIP_FRAMES) % 2) for h in handles}

        r = GgrsRunner(app, session, read_inputs=read_inputs, speculation=spec,
                       measure_rollback_service=True)
        r.ring_materialize_bytes = guard_bytes
        runners.append(r)
    for _ in range(5000):
        net.deliver()
        for r in runners:
            r.update(0.0)
        if all(r.session.current_state().value == "running" for r in runners):
            break
    else:
        raise SystemExit("torch_port_profile: the sessions never synchronized")
    _drive(net, runners, SERVICE_WARMUP_TICKS)

    def census():
        return {"hits": sum(r.spec_cache.hits for r in runners),
                "misses": sum(r.spec_cache.misses for r in runners),
                "served": sum(r.cache_served_frames for r in runners),
                "cloned": sum(r.materialized_saves for r in runners),
                "n": {p: sum(len(r.rollback_service_ms[p]) for r in runners)
                      for p in ("hit", "miss")}}

    before = census()
    first = [{p: len(r.rollback_service_ms[p]) for p in ("hit", "miss")} for r in runners]
    _drive(net, runners, SERVICE_TICKS)
    torch.cuda.synchronize()
    after = census()
    service = {}
    for p in ("hit", "miss"):
        ms = sum((r.rollback_service_ms[p][f[p]:] for r, f in zip(runners, first)), [])
        p50, p99 = np.percentile(ms, [50, 99]).tolist() if ms else (None, None)
        service[p] = {"n": len(ms), "p50_ms": p50, "p99_ms": p99}
    for r in runners:
        r.finish()
    hits = after["hits"] - before["hits"]
    cloned = after["cloned"] - before["cloned"]
    return {"ring_materialize_bytes": guard_bytes, "hits": hits,
            "misses": after["misses"] - before["misses"],
            "cache_served_frames": after["served"] - before["served"],
            "saves_cloned": cloned, "saves_cloned_per_hit": cloned / hits if hits else None,
            "rollback_service_ms": service,
            "peak_memory_bytes": torch.cuda.max_memory_allocated(),
            "desyncs": sum(isinstance(e, DesyncDetected) for r in runners for e in r.events)}


def profile_service(entities: int) -> dict:
    default, raised = 64 * 2**20, 2**40
    runs = [service_run(entities, g) for g in (default, raised, raised, default)]
    if any(r["desyncs"] for r in runs):
        raise SystemExit(f"torch_port_profile: a hedging pair desynced: {runs}")
    return {"card": torch.cuda.get_device_name(0), "entities": entities,
            "ticks": SERVICE_TICKS, "runs": runs}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--entities", type=int, default=None,
                    help="stress_soa entities (1,000,000; 65,536 for --service)")
    ap.add_argument("--k", type=int, default=8)
    ap.add_argument("--calls", type=int, default=10)
    ap.add_argument("--p2p", action="store_true",
                    help="profile a P2P tick of a stress_soa pair instead of a resim")
    ap.add_argument("--mode", choices=sorted(MODES), default="pipelined",
                    help="the runner's dispatch mode for --p2p")
    ap.add_argument("--service", action="store_true",
                    help="a hedging pair's rollback service time, ring guard on and raised")
    ap.add_argument("--server", action="store_true",
                    help="a 16-lobby BatchedRunner server tick (8 P2P pairs)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_port_profile: no CUDA device", file=sys.stderr)
        return 1
    if args.service:
        print(json.dumps(profile_service(args.entities or 65_536)))
    elif args.server:
        print(json.dumps(profile_server(args.entities or 10_000)))
    elif args.p2p:
        print(json.dumps(profile_p2p(args.entities or 1_000_000, args.mode)))
    else:
        print(json.dumps(profile_resim(args.entities or 1_000_000, args.k, args.calls)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
