#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check it, phase by phase.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It imports the
port (``bevy_ggrs_tpu_torch``) and never JAX or the JAX package.  Each phase
prints one JSON line; any failure ends the script with a nonzero exit code
and no result.  The phases:

1. device   — the card's name and power limit (``nvidia-smi``); fails
               without CUDA;
2. build    — compiles ``csrc/checksum_fold.cu`` for sm_90a and the native
               session core ``native/ggrs_core/ggrs_core.cc`` side by side
               (timed);
3. kernel   — the checksum pass kernel against its plain torch version on
               the card, bit for bit: stress_soa 1M entities x k=8 with
               and without despawned rows, a frame slice of it, box_game /
               fixed_point worlds (L=2, int32), bool / bf16 / int64
               columns, a uint32 column, ragged N (100,003) and a frame
               slice of it (an unaligned storage offset), 20 components, k=1 and k=17, a
               custom hash and no checksummed component, and the P2P
               paths' shapes: stress_soa 1M and the 2-player box_game /
               fixed_point worlds at k=1 (a tick) and k=2 / k=3 (a
               rollback at input delay 0 / 1);
               kernel and plain
               times, the bound (bytes over HBM; integer operations per
               pipe, ALU and FMA, and their issue, over the card's rates);
4. capture  — ``world_checksums`` at 1M x k=8 under
               ``torch.cuda.set_sync_debug_mode("error")``; captured in a
               CUDA graph, replayed on a world changed in place, equal to
               an eager call; a profiler trace of the pass: its device
               kernels and host-to-device copies per call;
5. resim    — ``App.resim_fn`` on stress_soa at 1M entities x k=8 (the
               bench path), states and checksums: resim frames/s (median
               and spread of 5 reps x 10 calls), the checksum pass's share;
6. parity   — fixed_point's scripted 12-frame resim on the card and on CPU
               torch: the 64-bit checksums must match frame by frame; a
               4096-entity stress_soa resim is held to the CPU's states;
7. synctest — ``GgrsRunner`` + ``SyncTestSession`` at check_distance 7 with
               flipping inputs: box_game and fixed_point for 300 frames,
               stress_soa at 100k entities for 120 frames, a hierarchy of
               1,000 3-level chains with ``despawn_recursive`` in the step
               (300 frames; the despawned subtrees counted), stress_soa
               100k under ``QuantizeStrategy`` (bf16 ring, 120 frames);
               zero mismatches;
8. p2p      — pairs of port runners with ``P2PSession``s over a
               ``ChannelNetwork`` (3 hops, no loss), input delay 1,
               prediction window 8, checksums compared every frame; peer
               0's inputs flip every 7 frames, so peer 1 rolls back again
               and again: stress_soa at 1M entities, box_game and
               fixed_point, 240 frames each; per pair frames/s per peer,
               rollbacks and their depth, fold launches against resim
               calls (equal), checksum peeks that found nothing and forced
               readbacks, stalls, zero ``DesyncDetected``, equal confirmed
               checksums; the first stacked output of each resim depth the
               pair ran is held against the plain fold bit for bit; then a
               box_game pair whose peer 0 gets its
               ``pos`` offset must raise ``DesyncDetected`` within 60
               frames, and fixed_point's confirmed checksums on the card
               must equal the same pair's on the CPU;
9. telemetry — the telemetry package: (a) phase 8's stress_soa 1M and
               fixed_point pairs with telemetry off, then on (net stats at
               their default, the exporter scraped on 127.0.0.1 during the
               loop; the protocol on a clock that moves a frame per tick,
               so both runs play the same game): the same confirmed
               checksums, zero desyncs, one fold launch per resim, the loop
               under ``set_sync_debug_mode("error")`` with no forced
               readback or staging wait, kernels, copies and fills over 10
               profiled ticks equal on and off (up to one record of each
               kind, which the profiler can drop at a window's edge) in
               the first of three consecutive windows in which both runs
               played the same game (resims, frames, rollbacks, rolled-back
               frames and materialized saves),
               ``rollback_cause_total`` summing to ``rollbacks_total``,
               phase totals reconciling to wall time with at most 10%
               unattributed, the devmem ring row equal to ring frames x
               world bytes and ``census(strict=True)``, a valid Chrome
               trace whose two-peer merge has a cross-peer flow;
               (b) ``forced_desync``'s box_game pair with a forensics
               directory per peer: both write a report, each report's
               per-component parts equal to the fold's plain version and
               to the CPU's, the merge naming the first divergent frame
               and ``pos``, the forensics fold held to its plain version
               on its own k=1 stacks; (c) phase 12 (c)'s stress_soa pairs
               as one server for 80 ticks, telemetry off and on: the same
               confirmed checksums, the same device events per tick (as
               in (a)), a
               ``lobby`` label and a QoS score for every lobby, devmem rows
               of the worlds and the rings; (d) phase 11's hedged service
               pair with telemetry on: the speculation families equal to
               the caches' counters; (e) host ms per peer tick of a 1M pair
               with telemetry and the flight ring off, the flight ring
               only, and telemetry on, in turns on five pairs (printed,
               not gated);
10. pipeline — the runner's dispatch modes on the P2P traffic of phase 8
               (stress_soa 1M and fixed_point pairs, 240 timed frames
               after a warm-up): the defaults (pipelined, packed single
               upload, donation) and the sync baseline (``pipeline=False,
               packed=False``).  Both modes' confirmed checksums must be
               equal at every frame both confirm, fixed_point's also equal
               to a CPU pair's, with zero ``DesyncDetected`` and one fold
               launch per resim.  The pipelined loop runs under
               ``set_sync_debug_mode("error")`` with no forced readback and
               no staging wait (event waits are invisible to that mode, so
               the runner's counters are read too); a profiled window then
               counts host-to-device copies per resim (1 from pinned
               memory on the packed path, 2 on the sync path, 0 from
               pageable memory) and launches per tick.  Frames/s per peer,
               pipeline degradations, peek misses, materialized saves and
               ``torch.cuda.max_memory_allocated`` for both modes; then a
               stress_soa 100k SyncTest at d=7 in both modes: zero
               mismatches, equal checksum streams, donation on the
               pipelined run;
11. speculation — the branch axis and the speculation cache: the fold
               bit for bit on a branch-stacked stress_soa 1M x M=4 x
               depth 8 stack and a box_game [B=9, K=8] branched stack;
               one ``SpeculationCache.speculate`` at stress_soa 1M, M=4,
               depth 8, each lane's states and checksums equal to
               ``App.resim_fn`` on its inputs, its device kernels, host ms
               and device ms beside a plain k=8 resim's, and zero ``vmap``
               fallbacks; the JAX bench's speculation-service traffic
               (stress_soa 65,536, 6 hops, input delay 1, inputs flipping
               every 7 ticks, checksums compared every frame) on a hedged
               and a plain port pair, each measured window run with the
               compile guard enabled and armed after the warm-up (zero
               steady recompiles; a disarmed ``notify`` call's host ns
               printed, not gated): zero desyncs, hits > 0, hit rate >
               0.5, one packed upload per draft, one fold launch per resim
               and per draft, the two pairs' confirmed checksums equal,
               the fold bit for bit on the pairs' own resim and draft
               stacks; service ms by path (p50, p99), cache-served
               frames, peak memory; a canonical-branched box_game pair
               (depth 10, 9 lanes, one peer hedging) against a plain
               canonical pair, its loop under ``set_sync_debug_mode(
               "error")`` with no forced readback, no staging wait and one
               upload per dispatch, the fold bit for bit on its own
               [9 x 10] stacks;
               one ``branched_fn`` call at stress_soa 10,000 x 4 players,
               B=16, K=8: lane 0 equal to the canonical resim, each hedge
               lane to the canonical resim of its inputs;
12. batched — the many-worlds server: (a) first a full and a ragged
               wave of 8 lanes of a clock-reading app and of fixed_point,
               starts straddling I32_MAX, each lane from its own world:
               every lane bit-equal to the solo resim of its own frames;
               then packed exact waves of 16
               lobbies x stress_soa 10,000 and 64 x 65,536, k=8, starts
               spread (one lane straddling I32_MAX), lanes from four
               distinct worlds: every lane bit-equal
               to a solo ``App.resim_fn``, one fold launch per wave, the
               fold bit-exact on the wave's ``[M·k, N]`` stack;
               lobby-frames/s (median and spread of 5 reps x 30 chained
               waves), device events per wave, busy and idle shares;
               (b) a ``BatchedRunner`` over M=4 then M=16 SyncTest lobbies
               of ``stress.make_app(64, capacity=64)`` at d=2: kernels,
               copies and fills per steady tick (8 after 4 of warm-up)
               equal at both M; (c) 8 P2P pairs (16 lobbies) of stress_soa
               10,000, then 8 of fixed_point, in one BatchedRunner each
               (3 hops, input delay 1, window 8, checksums every frame,
               peer 0 flipping every 7 frames offset per pair), 240
               ticks under ``set_sync_debug_mode("error")``: zero desyncs,
               confirmed checksums equal to the same pairs on solo
               runners, fold launches = waves, zero fallback load rows,
               one upload per wave, no forced readback, no staging wait;
               (d) (c)'s stress_soa and fixed_point traffic with
               idle-lane drafts (and 16 lobbies waiting for players, whose
               lanes the drafts fill): hits > 0, confirmed checksums equal
               to (c)'s, the branch caches pinning no more bytes than
               their entries hold; (c) and (d) report peak device memory;
13. megastep — (a) SyncTest ``stress_soa`` 100k at d=7 with
               ``GgrsRunner(megastep=True)`` against the per-tick runner:
               equal checksum streams; (b) P2P pairs at
               ``coalesce_frames=4``, each update owing 4 frames (the P2P
               channel, inputs keyed by the session's frame),
               ``stress_soa`` 1M and ``fixed_point``, megastep against the
               default runner: equal confirmed checksums, ``fixed_point``
               equal to a CPU megastep pair's, fused ring loads, one upload
               and one fold launch per megastep dispatch, no forced
               readback or staging wait under ``set_sync_debug_mode(
               "error")``; ms and launches per flush beside the default
               runner's; (c) one megastep call at 1M captured in a CUDA
               graph and replayed with a fused-load prefix and a plain one:
               every output and the ring bit-equal to eager calls; the
               fold held to its plain version on (a)'s stacks after the
               count is read, and on (b)'s warm-up stacks (the megastep's
               ``[k_max, N]``) before the loop, whose peak memory is read
               from the end of the warm-up;
14. models  — particles at the reference's defaults (rate 100, ttl 120)
               as a P2P pair (loop under sync debug "error"), its game
               recorded and replayed through ``ReplaySession``; particles
               at rate 8,000 (capacity 1,024,064) under SyncTest d=7 with
               and without ``QuantizeStrategy`` (frames/s, device events
               per frame); its draws on the card bit-equal to the CPU's;
               its checkpoint saved, loaded and advanced to equal
               checksums, the schema digest pinned; crowd 512 x 2 under
               SyncTest and a 16-lane wave against solo resims (reported,
               with each reduction's lane-axis bit-equality); pong under
               SyncTest to a score; a ``fixed_point`` pair over
               ``RoomServer`` / ``RoomSocket`` on loopback; one frame's
               particle draws profiled alone (their share of the frame's
               device events, host and device time); the fold held to its
               plain version on the stacks of every driven run (the pair,
               both 1M SyncTests, crowd, pong, the room pair) and on the
               crowd wave's;
15. spectator — a box_game host pair streaming to a port
               ``SpectatorSession``: it reaches RUNNING and its checksum
               at each frame equals the host's confirmed checksum there;
16. native  — a port ``NativeP2PSession`` peer against a port
               ``P2PSession`` peer, fixed_point on the card, over loopback
               UDP at input delay 0: the native peer steps first on a
               clock 10% fast, so it predicts the Python peer's flipping
               input and rolls back;
               both RUNNING, 120 frames, zero desyncs, equal confirmed
               checksums;
17. fleet   — (a) a ``FleetScheduler`` and two ``FleetWorker``s on the
               card in this process over loopback UDP, ``ckpt_every_frames``
               120: six ``stress_soa`` lobbies at 10,000 entities, one at
               65,536 (a ~1.5 MB checkpoint, ~50 chunks of 32 KiB) and one
               external ``box_game`` lobby fed its inputs, 600 frames each;
               inert external fillers fill the fleet and a wire SUBMIT must
               come back REJECT ``capacity``; at a third of the run a 10,000
               lobby and the 65,536 lobby migrate live; at half, the worker
               hosting the most running lobbies is closed and its lobbies
               fail over from their last confirmed checkpoints.  The
               workers take 8 lobbies each: with 4 the survivor would have
               no free slot for the victim's lobbies, and the scheduler
               strands a lobby it cannot place.  Gates: every final
               checksum (its DONE datagram) equal to an unmigrated control
               of its spec on the card, bit for bit; both migrations
               ``outcome=ok`` and a failover resuming at frame > 0 in
               ``lobby_migrations_total``; fold launches equal to chunk
               dispatches plus checksum calls; a profiled window of one
               lobby: one pinned host-to-device copy per chunk, none
               pageable (the staging queue's commits exact, the trace
               allowed to miss one chunk's copy record at the window's
               edge, as in phase 10); ``spec_est_bytes`` equal to the world tensors'
               bytes on the card; the fold held to its plain version on a
               chunk's ``[16, N]`` stack and a checksum call's ``[1, N]``
               (10,000, 65,536, box_game).  Printed: lobby-frames/s, frames/s
               per lobby, ms per chunk, each migration's downtime, the
               65,536 checkpoint's re-ship rounds, peak device memory.
               (b) the JAX bench's fleet stage with the port's CLIs: two
               ``scripts/torch_fleet_worker.py`` processes on the card
               (capacity 3, paced at 240 frames/s), 3 ``stress_soa`` lobbies
               of 256 entities to 1,500 frames (the last to 6,000), a live
               migration, a SIGSTOP that fires exactly one
               ``heartbeat_liveness`` alert and resolves after SIGCONT,
               ``/fleet``, ``/qos`` and ``/metrics`` with ``worker=`` labels,
               a SIGKILL failover resuming at frame > 0, an overflow REJECT,
               a valid three-participant merged trace with a cross-pid
               ``migration`` flow, every final checksum equal to an
               in-process control on the card;
18. sharded — multi-device: (a) ``ShardedWaveExecutor`` over four
               logical shards of the card at stress_soa 64 lobbies x
               65,536, k=8 packed waves (exact, ragged, M=62 with two pad
               lanes): every lane bit-equal to ``BucketedWaveExecutor``'s,
               one fold launch per shard; the ``harvest_shards`` census;
               lobby-frames/s sharded against unsharded over alternating
               pairs.  (b) ``BatchedRunner(mesh=make_lobby_mesh())`` keeps
               the plain executor on one card; with four logical shards, 14
               SyncTest lobbies of stress_soa 10,000 for 40 ticks match the
               unsharded runner tick for tick with equal dispatches, two pad
               lanes, and no host sync in the loop.  (c) a one-rank NCCL
               group and ``make_mesh(1, 1)``: the sharded resim at
               stress_soa 1M x k=8, speculate and the canonical program
               bit-equal to the one-device calls; a SyncTest driver over the
               sharded world (24 ticks) gives the unsharded checksums.  (d)
               the split fold (partials of 2 and 4 row blocks, summed slots,
               finalize) bit-equal to the one-call fold and the plain
               version, with both paths' times.  (e) two example twins as
               subprocesses with no platform set run on the card;
19. surface — the public surface's tail: (a) stress_soa at 1M built
               from top-level names (``App``, ``spawn_many``,
               ``DEFAULT_FPS``) equal to ``stress_soa.make_app``'s world;
               ``ops.make_advance_fn`` over 8 frames, each frame's state
               and checksum bit-equal to ``App.resim_fn``'s k=8 outputs,
               one fold launch per call, the last ``world_checksum`` equal
               to the plain fold's; ms per frame against ``resim_fn``'s,
               in turns; (b) ``GgrsRunner.profile`` around 20 SyncTest
               ticks at stress_soa 100,000: one ``*.pt.trace.json`` with
               at least one ``fold_kernel`` kernel and no more than the
               fold launches counted in the window (a window can lose
               records at its start); (c) ``readback_stats`` on phase 8's
               default 1M pair: no forced read and some harvested in the
               steady loop, equal to the runners' own counts, every
               landed ``checksum_peek`` equal to ``to_int``; (d)
               ``scripts/torch_e2e_p2p_check.py``'s pair over loopback UDP
               in this process, box_game as in the script, then stress_soa
               1M with peer 0 flipping every frame, 300 ticks per phase: zero
               desyncs, equal confirmed checksums, rollbacks, one fold
               launch per resim, frames/s per peer beside phase 8's
               channel pair; (e) ``scripts/torch_parity_check.py`` as a
               subprocess exits 0;
20. result  — the kernels line, the card line, then
               ``{"ok": true, "device": {...}}`` as the last line.

Every runner phase runs the runner's defaults unless it names a mode.
Kernel launch counts are reset just before each driven path and read just
after it; a path that did not launch the kernel fails.  Launches made to
compare the kernel with its plain version are not counted.  The session
phases (8 to 16) also hold the fold's output on the stacks their resims
produced against the plain version (phase 9 on the forensics pass's own
stacks), after the counts are read (phase 13's P2P pairs before the loop,
on their warm-up's stacks).
"""

from __future__ import annotations

import dataclasses
import gc
import json
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent

# H100 SXM data-sheet HBM3 bandwidth (700 W).  The integer rates are
# computed from the card.  Compute capability 9.0 retires 64 results per
# clock per SM of 32-bit integer add, shift, funnel shift and logic, and 64
# of 32-bit integer multiply and multiply-add (CUDA C++ Programming Guide,
# arithmetic instruction throughput table).  The two run on different
# pipes: IMAD on the FMA pipe, xor/shift/funnel shift/add on the integer
# ALU pipe, side by side.  An SM issues at most one warp instruction per
# clock in each of its 4 sub-partitions: 128 thread operations per clock.
# Each rate is per SM, times the SM count and the max SM clock that
# nvidia-smi reports.
HBM_BYTES_PER_S = 3.35e12
ALU_OPS_PER_CLOCK_PER_SM = 64
FMA_PIPE_OPS_PER_CLOCK_PER_SM = 64
ISSUE_OPS_PER_CLOCK_PER_SM = 128

SIZES = {
    "bench_entities": 1_000_000,
    "bench_k": 8,
    "dtype_entities": 100_000,
    "ragged_entities": 100_003,
    "many_comps": 20,
    "profile_calls": 20,
    "synctest_frames": 300,
    "synctest_stress_entities": 100_000,
    "synctest_stress_frames": 120,
    "parity_stress_entities": 4096,
    "kernel_reps": 25,
    "resim_reps": 5,
    "resim_iters": 10,
    "p2p_frames": 240,
    "p2p_stress_entities": 1_000_000,
    "p2p_latency_hops": 3,
    "p2p_flip_frames": 7,
    "desync_offset_frame": 60,
    "desync_window": 60,
    "p2p_cpu_parity_frame": 200,
    "pipeline_warmup_frames": 30,
    "pipeline_frames": 240,
    "pipeline_profile_frames": 30,
    "spectator_frames": 160,
    "native_frames": 120,
    "spec_lanes": 4,
    "spec_depth": 8,
    "svc_entities": 65_536,
    "svc_latency_hops": 6,
    "svc_flip_ticks": 7,
    "svc_warm": 60,
    "svc_ticks": 150,
    "branched_depth": 8,
    "branched_lanes": 9,
    "branched_pair_depth": 10,  # the JAX soak's; >= window 8 + 1
    "branched_warm": 20,
    "branched_frames": 120,
    "branched_call_entities": 10_000,
    "branched_call_players": 4,
    "branched_call_lanes": 16,
    "wave_cells": ((16, 10_000), (64, 65_536)),  # lobbies x stress_soa entities
    "wave_reps": 5,
    "wave_iters": 30,
    "flat_warm": 4,
    "flat_ticks": 8,
    "server_pairs": 8,
    "server_entities": 10_000,
    "server_frames": 240,
    "server_spec_depth": 8,
    "hierarchy_chains": 1000,
    "hierarchy_levels": 3,
    "megastep_synctest_frames": 120,
    "megastep_frames": 240,
    "megastep_coalesce": 4,
    "megastep_warm_rounds": 4,
    "megastep_profile_rounds": 8,
    "particles_rate": 100,
    "particles_ttl": 120,
    "particles_frames": 240,
    "particles_big_rate": 8000,  # capacity 1,024,064: the headline resim's million
    "particles_big_frames": 60,
    "crowd_per_team": 512,
    "crowd_frames": 120,
    "crowd_lanes": 16,
    "crowd_lane_k": 8,
    "pong_frames": 200,  # the first goal at frame 82, the re-serve 45 frames later
    "room_frames": 120,
    "telemetry_profile_ticks": 10,
    "telemetry_profile_windows": 3,
    "telemetry_unattributed_max_pct": 10.0,  # the JAX bench's gate (telemetry/phases.py)
    "telemetry_server_ticks": 80,
    "telemetry_cost_pairs": 5,
    "telemetry_cost_frames": 40,
    "fleet_small_lobbies": 6,  # at server_entities; one more at svc_entities
    "fleet_frames": 600,
    "fleet_capacity": 8,  # per worker; see phase 17 (a)
    "fleet_ckpt_every": 120,
    "fleet_profile_chunks": 8,
    "fleet_cli_frames": 1500,  # bench.py FLEET_TARGET, FLEET_ENTITIES,
    "fleet_cli_entities": 256,  # FLEET_LOBBIES and FLEET_CAPACITY
    "fleet_cli_lobbies": 3,
    "fleet_cli_capacity": 3,
    "fleet_cli_wait_s": 180,
    "shard_count": 4,  # logical shards of the one card
    "shard_lobbies": 64,  # at shard_entities: the batched phase's large cell
    "shard_entities": 65_536,
    "shard_pairs": 5,
    "shard_iters": 5,
    "shard_runner_lobbies": 14,  # 16 lanes on 4 shards: two pad lanes
    "shard_runner_ticks": 40,
    "shard_driver_ticks": 24,
    "shard_twin_timeout_s": 120,
    "surface_profile_entities": 100_000,
    "surface_profile_ticks": 20,
    "surface_readback_warm": 30,
    "surface_readback_frames": 120,
    "surface_advance_reps": 5,
    "surface_udp_ticks": 300,  # per phase of the twin: lockstep, then staggered
    "surface_tool_timeout_s": 120,
}

# particles.make_app(rate=8000)'s checkpoint schema digest, pinned by
# tests/test_torch_persist_replay.py (equal in the JAX package)
PARTICLES_BIG_DIGEST = "e8a7d06a008d4b36a5f3810145315adf63cc9ce8e737820f994c9d829fc6ace3"


T0 = time.perf_counter()


def emit(phase: str, **fields) -> None:
    """One phase's JSON line, stamped with the seconds since the start."""
    print(json.dumps({"phase": phase, "elapsed_s": time.perf_counter() - T0, **fields}),
          flush=True)


def nvidia_smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def card_line() -> str:
    return nvidia_smi("name,power.limit")


def sm_clocks_per_s() -> float:
    """SMs x the max SM clock (``clocks.max.sm``): SM clocks per second."""
    mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    return torch.cuda.get_device_properties(0).multi_processor_count * mhz * 1e6


def sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def time_ms(fn, reps: int) -> float:
    """Median milliseconds of one ``fn()`` call on its own (the host's time
    to enqueue it included), timed with CUDA events around each of ``reps``
    runs after two warm-up runs."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def run_ms(fn, calls: int) -> float:
    """Milliseconds per call over a run of ``calls`` back-to-back calls,
    timed with CUDA events around the run after two warm-up calls: the
    device's time when the host enqueues calls faster than they run."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


# -- the fold's inputs and its bound --------------------------------------------


def fold_inputs(reg, stacked):
    """The checksum_fold arguments for every checksummed component."""
    from bevy_ggrs_tpu_torch.snapshot.checksum import fold_inputs as inputs

    return inputs(reg, stacked, [n for n, s in reg.components.items() if s.checksum])


def fold_bound(args) -> dict:
    """Least time for the checksum pass on these inputs, the largest of:

    - bytes: every byte it needs read once (a row's alive byte; its pending
      byte only if alive; a has byte only if active; lanes only if kept;
      the id if kept by any component; ``next_id``) and its output written
      once, over HBM bandwidth;
    - the 32-bit integer operations these rows need, counted per pipe, the
      seed-independent key half of mix32 once per lane and once per row
      for the id, only kept rows hashed:

      - integer ALU (xor, shift, funnel shift, add), per kept row and
        component with L lanes: the key half's rotate per lane (L); per
        seed the state half's xor and rotate per lane (2L), fmix32 of
        ``h ^ L`` (6: the ``^ L`` shares one three-input xor with the
        first xor-shift, since L < 2**16), the id's state half (2) and
        fmix32 (6); 1 per active row to mask the has byte.  Per row: alive
        and not pending, and the count (2); the id's rotate (1) if any
        component keeps the row;
      - FMA pipe (IMUL, IMAD), per kept row and component: the key half's
        two multiplies per lane (2L); per seed the state half's
        multiply-add per lane (L), fmix32's two multiplies twice (4), the
        id's state half (1) and the masked add into the sum, one
        multiply-add ``h * keep + sum`` (1).  Per row kept by any
        component: the id's two multiplies (2);
      - issue: both together, at 128 per clock per SM.

      Per frame: the tag and fmix32 of each part, the XOR across parts and
      the entity part, on the same pipes.

    Each count is over its rate; the largest time is the bound."""
    lanes, has, ids, alive, pending, _, _, _ = args
    k, n = ids.shape
    active = alive & ~pending
    n_comps = len(lanes)
    n_active = int(active.sum())
    nbytes = k * n + int(alive.sum()) + k * 4 + k * (1 + n_comps) * 2 * 8
    alu = 2 * k * n + k * 2 * (8 * n_comps + 13)
    fma = k * 2 * (2 * n_comps + 8)
    any_keep = torch.zeros_like(alive)
    for ln, hs in zip(lanes, has):
        keep = active & hs
        n_keep = int(keep.sum())
        n_lanes = ln.shape[2]
        nbytes += n_active + n_keep * n_lanes * 4
        alu += n_active + n_keep * (5 * n_lanes + 28)
        fma += n_keep * (4 * n_lanes + 12)
        any_keep |= keep
    n_any = int(any_keep.sum())
    nbytes += n_any * 4
    alu += n_any
    fma += 2 * n_any
    clocks = sm_clocks_per_s()
    times = {
        "bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3,
        "alu_ms": alu / (ALU_OPS_PER_CLOCK_PER_SM * clocks) * 1e3,
        "fma_pipe_ms": fma / (FMA_PIPE_OPS_PER_CLOCK_PER_SM * clocks) * 1e3,
        "issue_ms": (alu + fma) / (ISSUE_OPS_PER_CLOCK_PER_SM * clocks) * 1e3,
    }
    bound_ms = max(times.values())
    return {"bytes": nbytes, "alu_ops": alu, "fma_pipe_ops": fma,
            "sm_clocks_per_s": clocks, **times, "bound_ms": bound_ms,
            "bound_term": max(times, key=times.get),
            "bound_by": "bytes" if times["bytes_ms"] >= bound_ms else "operations"}


def device_profile(fn, calls: int) -> dict:
    """Device events per call of ``fn`` from a ``torch.profiler`` trace:
    kernels and copies by name, device ms, and the host ms per call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3 / calls
        torch.cuda.synchronize()
    events = {}
    device_us = 0.0
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = next((float(getattr(e, a)) for a in ("self_device_time_total",
                                                   "self_cuda_time_total")
                   if hasattr(e, a)), 0.0)
        # summed: kernels whose names share their first 80 characters
        # (template instances) would overwrite each other's counts
        slot = events.setdefault(e.key[:80], {"per_call": 0.0, "ms_per_call": 0.0})
        slot["per_call"] += e.count / calls
        slot["ms_per_call"] += us / 1e3 / calls
        device_us += us
    return {"events": events, "device_ms_per_call": device_us / 1e3 / calls,
            "host_ms_per_call": host_ms,
            "device_events_per_call": sum(v["per_call"] for v in events.values()),
            "htod_copies_per_call": sum(v["per_call"] for n, v in events.items()
                                        if "HtoD" in n),
            "profiler_saw_device": bool(events)}


def on_device(x, dev) -> torch.Tensor:
    """A host array as a tensor on ``dev`` (set-up only: the resim takes
    device tensors and never copies from pageable host memory itself)."""
    return torch.as_tensor(x).to(dev)


def flat_branches(stacked_b):
    """A branch-stacked ``[M, k, ...]`` world viewed as ``[M * k, ...]``."""
    from bevy_ggrs_tpu_torch.utils.tree import tree_map

    m, k = stacked_b.alive.shape[:2]
    return tree_map(lambda a: a.reshape(m * k, *a.shape[2:]), stacked_b)


def branch_inputs(app, cands, depth: int):
    """Each candidate row held for ``depth`` frames, statuses confirmed:
    ``[M, depth, P]`` inputs and statuses on the app's device."""
    inputs = np.repeat(np.asarray(cands, app.input_dtype)[:, None], depth, axis=1)
    status = np.zeros(inputs.shape[:3], np.int8)
    return on_device(inputs, app.device), on_device(status, app.device)


def speculate_stack(app, world):
    """The ``[M, depth, ...]`` stack of one ``speculate_fn`` call with the
    service traffic's candidates (both pads over {0, 1})."""
    from bevy_ggrs_tpu_torch import pad_candidates

    cands = pad_candidates(2, [0, 1], [0, 1])(np.zeros(2, np.uint8))
    inputs, status = branch_inputs(app, cands, SIZES["spec_depth"])
    return app.speculate_fn(world, inputs, status, 0)[1]


def branched_app(make_app, dev, lanes=None, depth=None):
    """``make_app`` configured for the canonical-branched program."""
    app = make_app()
    app.canonical_depth = depth or SIZES["branched_depth"]
    app.canonical_branches = lanes or SIZES["branched_lanes"]
    return app


def branched_stack(dev):
    """A box_game ``[B, K]`` branched stack: lane 0 three real frames,
    the hedge lanes all K."""
    from bevy_ggrs_tpu_torch.models import box_game

    app = branched_app(lambda: box_game.make_app(device=dev), dev)
    lanes, depth = app.canonical_branches, app.canonical_depth
    rng = np.random.default_rng(5)
    inputs = on_device(rng.integers(0, 16, (lanes, depth, 2)).astype(np.uint8), dev)
    status = on_device(np.zeros((lanes, depth, 2), np.int8), dev)
    n_real = [3] + [depth] * (lanes - 1)
    return app, app.branched_fn(app.init_state(), inputs, status, 0, n_real)[1]


def stacked_of(app, world, k: int):
    """A ``[k, ...]`` stack of worlds from a k-frame resim with fixed inputs."""
    inputs = on_device(np.full((k, app.num_players), 5, np.uint8), app.device)
    status = on_device(np.zeros((k, app.num_players), np.int8), app.device)
    return app.resim_fn(world, inputs, status, 0)[1]


# -- phases ---------------------------------------------------------------------


def phase_device() -> str:
    line = card_line()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    import bevy_ggrs_tpu_torch

    pkg = Path(bevy_ggrs_tpu_torch.__file__).resolve().parent
    if pkg.parent != HERE:
        raise SystemExit(f"chip_smoke: the port was imported from {pkg}, not "
                         "from this checkout")
    emit("device", card=line, kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0])
    return line


def phase_build() -> None:
    """nvcc for the fold and g++ for the session core, started together."""
    from bevy_ggrs_tpu_torch.ops import checksum_fold
    from bevy_ggrs_tpu_torch.session import native

    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        fold = pool.submit(checksum_fold.build_library)
        core = pool.submit(native.build_library)
        lib, core_lib = fold.result(), core.result()
    checksum_fold._library()
    native.load_library()
    log = lib.with_suffix(".log")
    emit("build", seconds=time.perf_counter() - t0, library=lib.name,
         native_library=core_lib.name,
         ptxas=[ln.strip() for ln in (log.read_text().splitlines() if log.exists() else [])
                if "Function properties" in ln or "registers" in ln or "spill" in ln])


def kernel_cases(dev) -> dict:
    """name -> (registry, stacked world) for every case the kernel is held to."""
    from bevy_ggrs_tpu_torch import App
    from bevy_ggrs_tpu_torch.models import box_game, fixed_point, stress_soa
    from bevy_ggrs_tpu_torch.snapshot import despawn_where, spawn_many
    from bevy_ggrs_tpu_torch.utils.tree import tree_map

    n_bench, k = SIZES["bench_entities"], SIZES["bench_k"]
    n_small = SIZES["dtype_entities"]
    gen = torch.Generator(device="cpu").manual_seed(11)
    rng = np.random.default_rng(3)

    def with_despawns(app, w, frac):
        kill = (torch.rand(app.reg.capacity, generator=gen) < frac).to(dev)
        return despawn_where(app.reg, w, kill, 0)

    def frames(stacked, lo, hi):
        return tree_map(lambda a: a[lo:hi], stacked)

    def columns_app(n, specs):
        """An App with identity step and columns ``name -> (shape, dtype,
        hash_fn)``, seeded values, a tenth of its rows despawned."""
        app = App(capacity=n, device=dev)
        cols = {}
        for name, (shape, dtype, hash_fn) in specs.items():
            app.rollback_component(name, shape, dtype, checksum=True, hash_fn=hash_fn)
            size = (n, *shape)
            if dtype == torch.bool:
                cols[name] = rng.integers(0, 2, size).astype(bool)
            elif dtype.is_floating_point:
                cols[name] = torch.from_numpy(
                    rng.standard_normal(size).astype(np.float32)).to(dtype)
            else:
                cols[name] = rng.integers(-2**31, 2**31, size, dtype=np.int64).astype(
                    np.int64 if dtype == torch.int64 else np.int32)
        app.set_step(lambda w, ctx: w)
        world = spawn_many(app.reg, app.init_state(), cols, n - 100)
        return app, with_despawns(app, world, 0.1)

    cases = {}
    bench_app = stress_soa.make_app(n_entities=n_bench, device=dev)
    bench_world = bench_app.init_state()
    bench = stacked_of(bench_app, bench_world, k)
    cases["stress_soa_1M_k8"] = (bench_app.reg, bench)
    cases["stress_soa_1M_k8_despawned"] = (
        bench_app.reg, stacked_of(bench_app, with_despawns(bench_app, bench_world, 0.1), k))
    cases["stress_soa_1M_frames_3_to_7"] = (bench_app.reg, frames(bench, 3, 7))
    for depth in (1, 3):  # a P2P tick and a rollback
        cases[f"stress_soa_1M_k{depth}"] = (bench_app.reg,
                                            stacked_of(bench_app, bench_world, depth))
    for name, mod in (("box_game", box_game), ("fixed_point", fixed_point)):
        app = mod.make_app(num_players=4, capacity=64, device=dev)
        cases[f"{name}_k8"] = (app.reg, stacked_of(app, app.init_state(), k))
        pair_app = mod.make_app(device=dev)  # the P2P pairs' 2-player world
        for depth in (1, 2, 3):
            cases[f"{name}_2p_k{depth}"] = (
                pair_app.reg, stacked_of(pair_app, pair_app.init_state(), depth))
    app, world = columns_app(n_small, {"flag": ((), torch.bool, None),
                                       "half": ((3,), torch.bfloat16, None),
                                       "big": ((2,), torch.int64, None)})
    cases["bool_bf16_int64"] = (app.reg, stacked_of(app, world, k))
    # a uint32 column (the fold reads its bits): an int32 stack viewed so
    u32 = App(capacity=n_small, device=dev)
    u32.rollback_component("word", (2,), torch.uint32, checksum=True)
    app, world = columns_app(n_small, {"word": ((2,), torch.int32, None)})
    stack = stacked_of(app, world, k)
    cases["uint32"] = (u32.reg, dataclasses.replace(
        stack, comps={"word": stack.comps["word"].view(torch.uint32)}))
    ragged = stress_soa.make_app(n_entities=SIZES["ragged_entities"], device=dev)
    ragged_stack = stacked_of(ragged, with_despawns(ragged, ragged.init_state(), 0.1), k)
    cases["ragged_100003_k8"] = (ragged.reg, ragged_stack)
    cases["ragged_100003_frames_1_to_6"] = (ragged.reg, frames(ragged_stack, 1, 6))
    cases["ragged_100003_frame_5"] = (ragged.reg, frames(ragged_stack, 5, 6))
    n_comps = SIZES["many_comps"]
    app, world = columns_app(n_small, {
        f"c{i}": ([(), (2,), (3,), (4,)][i % 4], torch.float32 if i % 2 else torch.int32,
                  None) for i in range(n_comps)})
    cases[f"{n_comps}_components_k8"] = (app.reg, stacked_of(app, world, k))
    small = stress_soa.make_app(n_entities=n_small, device=dev)
    small_world = with_despawns(small, small.init_state(), 0.1)
    for depth in (1, 17):
        cases[f"stress_soa_100k_k{depth}"] = (small.reg, stacked_of(small, small_world, depth))
    app, world = columns_app(n_small, {"hp": ((), torch.int32, lambda col: col * 31 + 5),
                                       "pos": ((2,), torch.float32, None)})
    cases["custom_hash_fn"] = (app.reg, stacked_of(app, world, k))
    none = stress_soa.make_app(n_entities=n_small, checksum=False, device=dev)
    cases["no_checksummed_component"] = (
        none.reg, stacked_of(none, with_despawns(none, none.init_state(), 0.1), k))
    m, depth = SIZES["spec_lanes"], SIZES["spec_depth"]
    cases[f"stress_soa_1M_branches_M{m}_k{depth}"] = (
        bench_app.reg, flat_branches(speculate_stack(bench_app, bench_world)))
    app, stack = branched_stack(dev)
    cases[f"box_game_branched_B{SIZES['branched_lanes']}_K{SIZES['branched_depth']}"] = (
        app.reg, flat_branches(stack))
    return cases


def phase_kernel(dev) -> dict:
    """Kernel against plain, bit for bit, on every case; times at the bench
    shape (the main path's)."""
    from bevy_ggrs_tpu_torch.ops import checksum_fold as cf

    cases = kernel_cases(dev)
    max_err = 0
    checked = {}
    for name, (reg, stacked) in cases.items():
        args = fold_inputs(reg, stacked)
        got = cf.checksum_fold(*args)
        want = cf.checksum_fold_plain(*args)
        sync(dev)
        err = int((got - want).abs().max())
        max_err = max(max_err, err)
        checked[name] = {"shape": list(args[2].shape), "comps": len(args[0]),
                         "vector_loads": cf.vector_loads(
                             args[2].shape[1], [args[2], args[3], args[4], *args[0], *args[1]]),
                         "max_abs_err": err}
        if tuple(got.shape) != tuple(want.shape) or err != 0:
            raise SystemExit(f"chip_smoke: checksum_fold disagrees with its plain "
                             f"version on {name} (max abs err {err})")
    bench_reg, bench = cases["stress_soa_1M_k8"]
    bench_args = fold_inputs(bench_reg, bench)
    ms = time_ms(lambda: cf.checksum_fold(*bench_args), SIZES["kernel_reps"])
    back_to_back_ms = run_ms(lambda: cf.checksum_fold(*bench_args), SIZES["kernel_reps"])
    plain_ms = time_ms(lambda: cf.checksum_fold_plain(*bench_args), SIZES["kernel_reps"])
    prof = device_profile(lambda: cf.checksum_fold(*bench_args), SIZES["profile_calls"])
    bound = fold_bound(bench_args)
    alone_ms = prof["device_ms_per_call"]
    result = {"max_abs_err": max_err, "ms": ms, "back_to_back_ms": back_to_back_ms,
              "plain_ms": plain_ms, **bound}
    emit("kernel", name="checksum_fold", tolerance="bit-exact (0)", cases=checked,
         at="stress_soa 1M x k=8, 6 f32 columns", **result,
         bound_us=bound["bound_ms"] * 1e3,
         kernels_alone_ms=alone_ms, kernel_events=prof["events"],
         achieved_gb_s=bound["bytes"] / (ms * 1e-3) / 1e9,
         achieved_alu_ops_per_s=bound["alu_ops"] / (ms * 1e-3),
         roofline_share=bound["bound_ms"] / ms,
         roofline_share_back_to_back=bound["bound_ms"] / back_to_back_ms,
         roofline_share_kernels_alone=bound["bound_ms"] / alone_ms if alone_ms else None)
    return result


def phase_capture(dev) -> dict:
    """The checksum pass at 1M x k=8: no host sync, safe in a CUDA graph,
    and its device kernels and host-to-device copies per call."""
    from bevy_ggrs_tpu_torch.models import stress_soa
    from bevy_ggrs_tpu_torch.ops import checksum_fold as cf
    from bevy_ggrs_tpu_torch.snapshot import world_checksums

    app = stress_soa.make_app(n_entities=SIZES["bench_entities"], device=dev)
    stacked = stacked_of(app, app.init_state(), SIZES["bench_k"])
    reg = app.reg
    world_checksums(reg, stacked)
    sync(dev)
    torch.cuda.set_sync_debug_mode("error")
    try:
        world_checksums(reg, stacked)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    sync(dev)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        world_checksums(reg, stacked)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    cf.launches = 0
    with torch.cuda.graph(graph):
        captured = world_checksums(reg, stacked)
    capture_launches = cf.launches
    graph.replay()
    sync(dev)
    before = captured.clone()
    with torch.no_grad():
        stacked.comps["x"].add_(1.0)
        stacked.despawn_pending[:, ::7] = True
        stacked.next_id.add_(3)
    graph.replay()
    eager = world_checksums(reg, stacked)
    sync(dev)
    if not torch.equal(captured, eager):
        raise SystemExit("chip_smoke: the captured checksum pass disagrees with an "
                         "eager call after replay")
    if torch.equal(captured, before):
        raise SystemExit("chip_smoke: the replayed checksum pass did not see the "
                         "changed world")
    if capture_launches != 1:
        raise SystemExit(f"chip_smoke: capture launched the fold {capture_launches} "
                         "times, not once")
    pass_ms = time_ms(lambda: world_checksums(reg, stacked), SIZES["kernel_reps"])
    pass_run_ms = run_ms(lambda: world_checksums(reg, stacked), SIZES["kernel_reps"])
    prof = device_profile(lambda: world_checksums(reg, stacked), SIZES["profile_calls"])
    if prof["profiler_saw_device"]:
        if prof["htod_copies_per_call"] != 0:
            raise SystemExit(f"chip_smoke: the checksum pass copies to the device: "
                             f"{prof['events']}")
        if prof["device_events_per_call"] > 2:
            raise SystemExit(f"chip_smoke: the checksum pass runs more than 2 device "
                             f"kernels per call: {prof['events']}")
    result = {"sync_debug_error_mode": "no sync", "graph_replay_bit_exact": True,
              "checksum_pass_ms": pass_ms, "checksum_pass_back_to_back_ms": pass_run_ms,
              **prof}
    if not prof["profiler_saw_device"]:
        result["note"] = ("the profiler gave no device events; host_ms_per_call is "
                          "the call's host time")
    emit("capture", at="stress_soa 1M x k=8", **result)
    return result


def phase_resim(dev) -> int:
    """The bench path: ``App.resim_fn`` on stress_soa 1M x k=8."""
    from bevy_ggrs_tpu_torch.models import stress_soa
    from bevy_ggrs_tpu_torch.ops import checksum_fold as cf
    from bevy_ggrs_tpu_torch.snapshot import world_checksums

    n, k = SIZES["bench_entities"], SIZES["bench_k"]
    app = stress_soa.make_app(n_entities=n, device=dev)
    world = app.init_state()
    inputs = on_device(np.zeros((k, 2), np.uint8), dev)
    status = on_device(np.zeros((k, 2), np.int8), dev)
    for _ in range(2):  # warm-up
        app.resim_fn(world, inputs, status, 0)
    sync(dev)
    cf.launches = 0
    fps = []
    for _ in range(SIZES["resim_reps"]):
        t0 = time.perf_counter()
        for _ in range(SIZES["resim_iters"]):
            final, stacked, checks = app.resim_fn(world, inputs, status, 0)
        sync(dev)
        fps.append(SIZES["resim_iters"] * k / (time.perf_counter() - t0))
    launches = cf.launches
    calls = SIZES["resim_reps"] * SIZES["resim_iters"]
    if launches != calls:
        raise SystemExit(f"chip_smoke: resim launched the fold {launches} times "
                         f"in {calls} calls")
    if tuple(checks.shape) != (k, 2) or not all(
            bool(torch.isfinite(c).all()) for c in stacked.comps.values()):
        raise SystemExit("chip_smoke: resim output has the wrong shape or "
                         "non-finite values")
    resim_ms = time_ms(lambda: app.resim_fn(world, inputs, status, 0), 10)
    checksum_ms = time_ms(lambda: world_checksums(app.reg, stacked), 10)
    emit("resim", model="stress_soa", entities=n, k=k,
         frames_per_s_median=statistics.median(fps), frames_per_s_min=min(fps),
         frames_per_s_max=max(fps), reps=fps, resim_ms=resim_ms,
         checksum_pass_ms=checksum_ms, checksum_share=checksum_ms / resim_ms,
         kernel_launches=launches, calls=calls)
    return launches


def phase_parity(dev) -> None:
    """fixed_point's checksums on the card equal CPU torch's exactly;
    stress_soa's states on the card stay within 1e-4 of CPU torch's."""
    from bevy_ggrs_tpu_torch.models import fixed_point, stress_soa
    from bevy_ggrs_tpu_torch.snapshot import checksum_to_int

    k = 12
    runs = {}
    for d in (dev, "cpu"):
        app = fixed_point.make_app(device=d)
        rng = np.random.default_rng(7)
        inputs = rng.integers(0, 16, (k, app.num_players)).astype(np.uint8)
        status = np.zeros((k, app.num_players), np.int8)
        _, _, checks = app.resim_fn(app.init_state(), on_device(inputs, d),
                                    on_device(status, d), 0)
        runs[d] = [checksum_to_int(c) for c in checks.cpu()]
    if runs[dev] != runs["cpu"]:
        raise SystemExit(f"chip_smoke: fixed_point checksums differ between "
                         f"{dev} and cpu: {runs[dev]} vs {runs['cpu']}")
    states = {}
    for d in (dev, "cpu"):
        app = stress_soa.make_app(n_entities=SIZES["parity_stress_entities"], device=d)
        zeros = on_device(np.zeros((8, 2), np.uint8), d)
        _, stacked, _ = app.resim_fn(app.init_state(), zeros, zeros.to(torch.int8), 0)
        states[d] = {c: v.cpu() for c, v in stacked.comps.items()}
    diff = max(float((states[dev][c] - states["cpu"][c]).abs().max()) for c in states["cpu"])
    if not diff <= 1e-4:
        raise SystemExit(f"chip_smoke: stress_soa on {dev} strays {diff} from cpu")
    emit("parity", fixed_point_frames=k, fixed_point_exact=True,
         fixed_point_last=hex(runs[dev][-1]), stress_soa_max_abs_diff=diff,
         stress_soa_tolerance=1e-4)


def synctest(app, frames: int, check_distance: int = 7, keep_runner: bool = False,
             read_inputs=None, check_fold: bool = False, **runner_kw) -> dict:
    """One SyncTest run through the runner (``runner_kw`` picks its
    dispatch mode, ``read_inputs`` its input function: flipping by
    default); a mismatch raises.  ``stream`` is the world checksum after each tick, read after
    the run; ``keep_runner`` adds the runner under ``runner``; on the card
    ``check_fold`` holds the fold against its plain version on the first
    stacked output of each shape the run made (``path_stacks_bit_exact``)."""
    from bevy_ggrs_tpu_torch import GgrsRunner, SessionBuilder
    from bevy_ggrs_tpu_torch.ops import checksum_fold as cf

    session = (SessionBuilder.for_app(app).with_check_distance(check_distance)
               .start_synctest_session())
    holder = []

    def flipping(handles):
        phase = (holder[0].frame // 7) % 4
        return {h: np.uint8(1 << ((phase + h) % 4)) for h in handles}

    runner = GgrsRunner(app, session, read_inputs=read_inputs or flipping, **runner_kw)
    holder.append(runner)
    check_fold = check_fold and app.device.type == "cuda"
    kept = keep_stacks([runner]) if check_fold else None
    sync(app.device)
    cf.launches = 0
    refs = []
    t0 = time.perf_counter()
    for _ in range(frames):
        runner.tick()
        refs.append(runner._world_checksum)
    runner.finish()
    sync(app.device)
    dt = time.perf_counter() - t0
    launches = cf.launches
    if launches == 0:
        raise SystemExit("chip_smoke: the SyncTest run never launched the fold")
    if runner.frame != frames or session.pending_comparisons() != 0:
        raise SystemExit("chip_smoke: SyncTest run ended short or uncompared")
    from bevy_ggrs_tpu_torch.snapshot import active_count

    checked = ({"path_stacks_bit_exact": check_stacks("synctest", kept)}
               if check_fold else {})
    del kept
    extra = {"runner": runner} if keep_runner else {}
    return {**extra, **checked, "frames": frames, "check_distance": check_distance,
            "active_entities": int(active_count(runner.world)),
            "frames_per_s": frames / dt, "seconds": dt, "rollbacks": runner.rollbacks,
            "resimulated_frames": runner.rollback_frames,
            "kernel_launches": launches, "mismatches": 0,
            "pipeline": runner.pipeline, "packed": runner.packed,
            "donated_dispatches": runner.donated_dispatches,
            "final_checksum": hex(runner.checksum), "stream": [ref() for ref in refs]}


def hierarchy_app(dev):
    """``BASELINE.md`` config 4: 1,000 parent/child chains (3 levels) whose
    entities age every frame; every 25th frame ``despawn_recursive`` takes
    one chain's root and its subtree (the slot is chosen by the frame)."""
    from bevy_ggrs_tpu_torch import App
    from bevy_ggrs_tpu_torch.snapshot import (
        Registry,
        active_mask,
        despawn_recursive,
        spawn_many,
    )

    chains, levels = SIZES["hierarchy_chains"], SIZES["hierarchy_levels"]
    app = App(num_players=2, capacity=chains * levels, device=dev)
    app.register_hierarchy()
    app.rollback_component("age", (), torch.int32, checksum=True)

    def step(world, ctx):
        m = active_mask(world) & world.has["age"]
        world = dataclasses.replace(world, comps={
            **world.comps, "age": torch.where(m, world.comps["age"] + 1, world.comps["age"])})
        if ctx.frame % 25 == 0:
            root = (ctx.frame // 25) % chains
            world = despawn_recursive(app.reg, world, root, ctx.frame)
        return world

    def setup(world):
        for level in range(levels):
            parents = (torch.arange(chains, dtype=torch.int32) + (level - 1) * chains
                       if level else torch.full((chains,), -1, dtype=torch.int32))
            world = spawn_many(app.reg, world, {
                Registry.PARENT: parents.to(dev),
                "age": torch.zeros(chains, dtype=torch.int32, device=dev)}, count=chains)
        return world

    app.set_step(step)
    app.set_setup(setup)
    return app


def phase_synctest(dev) -> None:
    from bevy_ggrs_tpu_torch import QuantizeStrategy
    from bevy_ggrs_tpu_torch.models import box_game, fixed_point, stress_soa

    runs = {
        "box_game": synctest(box_game.make_app(device=dev), SIZES["synctest_frames"]),
        "fixed_point": synctest(fixed_point.make_app(device=dev),
                                SIZES["synctest_frames"]),
        "stress_soa_100k": synctest(
            stress_soa.make_app(n_entities=SIZES["synctest_stress_entities"], device=dev),
            SIZES["synctest_stress_frames"]),
        "hierarchy_1k_chains": synctest(hierarchy_app(dev), SIZES["synctest_frames"]),
        "stress_soa_100k_quantized": synctest(
            stress_soa.make_app(n_entities=SIZES["synctest_stress_entities"], device=dev,
                                strategy=QuantizeStrategy()),
            SIZES["synctest_stress_frames"]),
    }
    chains, levels = SIZES["hierarchy_chains"], SIZES["hierarchy_levels"]
    taken = (SIZES["synctest_frames"] // 25) * levels  # subtrees despawned so far
    if runs["hierarchy_1k_chains"]["active_entities"] != chains * levels - taken:
        raise SystemExit(f"chip_smoke: the hierarchy SyncTest left "
                         f"{runs['hierarchy_1k_chains']['active_entities']} entities, "
                         f"not {chains * levels - taken}")
    for name, r in runs.items():
        r.pop("stream")
        emit("synctest", model=name, **r)


# -- P2P, spectator and native sessions -------------------------------------------


def frame_inputs(i: int, holder: list):
    """Peer ``i``'s inputs as a function of the frame: peer 0 flips between
    right and up every ``p2p_flip_frames`` frames, peer 1 holds right, so
    peer 1 mispredicts peer 0 and rolls back."""
    flip = SIZES["p2p_flip_frames"]

    def read_inputs(handles):
        on = i == 1 or (holder[0].frame // flip) % 2 == 0
        return {h: np.uint8(8 if on else 1) for h in handles}

    return read_inputs


def record_confirmed(runner) -> dict:
    """``frame -> checksum ref`` of each frame ``runner`` confirms, read
    from its ring when the frame confirms (forced later, off the clock)."""
    seen = {}

    def on_confirmed(frame):
        entry = runner.ring.peek(frame)
        if entry is not None:
            seen.setdefault(frame, entry[1])

    runner.on_confirmed = on_confirmed
    return seen


def p2p_peer(make_app, i: int, socket, peer_addr, native_port=None, spectator=None,
             input_delay: int = 1, inputs=None, **runner_kw):
    """One peer of a 2-player game (prediction window 8, checksums compared
    every frame); ``native_port`` makes it a native core session bound to
    that UDP port, ``spectator`` an address it streams confirmed inputs
    to; ``inputs(i, holder)`` builds its input function (``frame_inputs``
    unless given); ``runner_kw`` picks the runner's dispatch mode (its
    defaults: the pipelined, packed, donating path)."""
    from bevy_ggrs_tpu_torch import DesyncDetection, GgrsRunner, PlayerType, SessionBuilder

    app = make_app()
    b = (SessionBuilder.for_app(app).with_input_delay(input_delay)
         .with_max_prediction_window(8)
         .with_desync_detection_mode(DesyncDetection.on(1))
         .add_player(PlayerType.LOCAL, i).add_player(PlayerType.REMOTE, 1 - i, peer_addr))
    if spectator is not None:
        b.add_player(PlayerType.SPECTATOR, 2, spectator)
    if native_port is None:
        session = b.start_p2p_session(socket)
    else:
        session = b.start_p2p_session_native(local_port=native_port)
    holder = []
    runner = GgrsRunner(app, session, read_inputs=(inputs or frame_inputs)(i, holder),
                        **runner_kw)
    holder.append(runner)
    return runner


def sync_sessions(runners, net=None, sleep_s: float = 0.0) -> None:
    """Poll until every session is RUNNING (no frames advance)."""
    for _ in range(5000):
        if net is not None:
            net.deliver()
        for r in runners:
            r.update(0.0)
        if all(r.session.current_state().value == "running" for r in runners):
            return
        if sleep_s:
            time.sleep(sleep_s)
    raise SystemExit("chip_smoke: the sessions never synchronized")


def drive(runners, frames: int, net=None, step: int = 1) -> None:
    """``frames`` rounds of delivery and one update per runner, each
    update owing ``step`` frames (a coalescing runner flushes them in
    one request pass)."""
    for _ in range(frames):
        if net is not None:
            net.deliver()
        for r in runners:
            r.update(step / 60.0)


def desyncs(runner) -> list:
    from bevy_ggrs_tpu_torch.session.events import DesyncDetected

    return [e for e in runner.events if isinstance(e, DesyncDetected)]


def channel_pair(make_app, seed: int, **runner_kw):
    """Two port peers over a ChannelNetwork: (net, runners, confirmed refs)."""
    from bevy_ggrs_tpu_torch.session.channel import ChannelNetwork

    net = ChannelNetwork(latency_hops=SIZES["p2p_latency_hops"], loss=0.0, seed=seed)
    socks = [net.endpoint("p0"), net.endpoint("p1")]
    runners = [p2p_peer(make_app, i, socks[i], f"p{1 - i}", **runner_kw)
               for i in range(2)]
    return net, runners, [record_confirmed(r) for r in runners]


RESIM_FNS = ("resim_fn", "resim_fn_donated", "packed_resim_fn", "packed_resim_fn_donated")
BRANCH_FNS = ("speculate_fn", "packed_speculate_fn", "branched_fn")


class Kept(dict):
    """``shape -> (registry, stacked output)``; the wrappers stop keeping
    once ``open`` is False."""

    open = True


def keep_stacks(runners) -> Kept:
    """``shape -> (registry, stacked output)`` of the first call of each
    output shape the runners make, kept to hold the fold against its plain
    version on the main path's own tensors: through the app's resim
    functions (plain, donating, packed; key ``(k,)``), its branch-axis
    ones (speculate, branched; key ``(M, k)``, the stack viewed as
    ``[M * k, ...]``, as the fold sees it) and a megastep runner's
    program (key ``("megastep", k_max)``)."""
    kept = Kept()

    def keep(key, reg, stacked):
        if kept.open:
            kept.setdefault(key, (reg, stacked))

    for r in runners:
        app = r.app
        for name in RESIM_FNS + BRANCH_FNS:
            if name == "branched_fn" and app.canonical_branches is None:
                continue
            fn = getattr(app, name)
            if fn is None:
                continue

            def keeping(*args, fn=fn, reg=app.reg, branch=name in BRANCH_FNS):
                out = fn(*args)
                keep(tuple(out[2].shape[:-1]),
                     reg, flat_branches(out[1]) if branch else out[1])
                return out

            setattr(app, name, keeping)
        if getattr(r, "megastep", False):
            def wrap(r=r):
                fn = r._ms_fn

                def keeping(*args, fn=fn, reg=r.app.reg):
                    out = fn(*args)
                    keep(("megastep", *out[4].shape[:-1]), reg, out[3])
                    return out

                r._ms_fn = keeping

            def ensuring(r=r, ensure=r._ensure_megastep, wrap=wrap):
                fresh = r._ms_fn is None
                ensure()
                if fresh:  # the program is built per session: wrap each one
                    wrap()

            if r._ms_fn is not None:
                wrap()
            r._ensure_megastep = ensuring
    return kept


def check_stacks(name: str, kept: dict) -> list:
    """The fold on each kept stack, bit for bit against its plain version;
    returns the ``[F, N]`` shapes checked.  Run after the launch count is
    read: these launches are not the path's."""
    from bevy_ggrs_tpu_torch.ops import checksum_fold as cf

    shapes = []
    for key, (reg, stacked) in sorted(kept.items(), key=lambda kv: [-1 if isinstance(x, str) else x for x in kv[0]]):
        args = fold_inputs(reg, stacked)
        got, want = cf.checksum_fold(*args), cf.checksum_fold_plain(*args)
        if not torch.equal(got, want):
            raise SystemExit(f"chip_smoke: {name}: checksum_fold disagrees with its "
                             f"plain version on the path's {list(key)} output")
        shapes.append(list(args[2].shape))
    if not shapes:
        raise SystemExit(f"chip_smoke: {name}: no resim output to check")
    return shapes


def agreed_checksums(seen: list) -> dict:
    """The confirmed checksums every recorder holds, as ints; fails if two
    recorders disagree at a frame."""
    shared = sorted(set.intersection(*(set(s) for s in seen)))
    out = {}
    for f in shared:
        vals = {s[f]() for s in seen}
        if len(vals) != 1:
            raise SystemExit(f"chip_smoke: peers' confirmed checksums differ at frame {f}")
        out[f] = vals.pop()
    return out


def p2p_run(name: str, make_app, dev, seed: int) -> dict:
    """One pair for ``p2p_frames`` frames after sync; the fold must launch
    once per resim, the peers must roll back, stay in sync and agree."""
    from bevy_ggrs_tpu_torch.ops import checksum_fold as cf

    net, runners, seen = channel_pair(make_app, seed)
    sync_sessions(runners, net)
    kept = keep_stacks(runners)
    frames = SIZES["p2p_frames"]
    sync(dev)
    cf.launches = 0
    t0 = time.perf_counter()
    drive(runners, frames, net)
    sync(dev)
    dt = time.perf_counter() - t0
    launches = cf.launches
    resims = sum(r.resims for r in runners)
    reads = [dataclasses.asdict(r.readbacks) for r in runners]
    for r in runners:
        r.finish()
    agreed = agreed_checksums(seen)
    stack_shapes = check_stacks(name, kept) if dev.type == "cuda" else []
    rings = sorted(set(runners[0].ring.frames()) & set(runners[1].ring.frames()))
    ring_equal = all(runners[0].ring.peek(f)[1]() == runners[1].ring.peek(f)[1]()
                     for f in rings)
    result = {
        "pair": name, "device": str(dev), "frames": frames, "seconds": dt,
        "frames_per_s_per_peer": [r.frame / dt for r in runners],
        "final_frames": [r.frame for r in runners],
        "rollbacks": [r.rollbacks for r in runners],
        "resimulated_frames": [r.rollback_frames for r in runners],
        "mean_rollback_depth": [r.rollback_frames / r.rollbacks if r.rollbacks else 0.0
                                for r in runners],
        "rollbacks_by_cause": [{str(h): n for h, n in r.rollbacks_by_cause.items()}
                               for r in runners],
        "resim_calls": [r.resims for r in runners], "fold_launches": launches,
        "launches_per_resim": launches / resims if resims else None,
        "peek_misses": [x["peek_misses"] for x in reads],
        "forced_readbacks": [x["forced"] for x in reads],
        "harvested_readbacks": [x["harvested"] for x in reads],
        "stalls": [r.stalled_frames for r in runners],
        "desyncs": [len(desyncs(r)) for r in runners],
        "confirmed_frames_agreed": len(agreed), "ring_frames_agreed": len(rings),
        "path_stacks_bit_exact": stack_shapes,
    }
    if dev.type == "cuda" and launches != resims:
        raise SystemExit(f"chip_smoke: {name}: {launches} fold launches for "
                         f"{resims} resim calls")
    if runners[1].rollbacks == 0 or max(key[-1] for key in kept) < 2 \
            or min(r.frame for r in runners) < frames - 10:
        raise SystemExit(f"chip_smoke: {name}: no rollbacks or a short run: {result}")
    if any(result["desyncs"]) or not ring_equal or len(agreed) < frames // 2:
        raise SystemExit(f"chip_smoke: {name}: peers out of sync: {result}")
    result["agreed"] = agreed
    return result


def forced_desync(dev) -> dict:
    """A box_game pair whose peer 0 gets its ``pos`` offset mid-game must
    raise ``DesyncDetected`` within ``desync_window`` frames.  Peer 0
    predicts its remote perfectly, so it never rolls the offset away."""
    from bevy_ggrs_tpu_torch.models import box_game
    from bevy_ggrs_tpu_torch.snapshot.lazy import wrap_single_checksum

    net, runners, _ = channel_pair(lambda: box_game.make_app(device=dev), seed=3)
    sync_sessions(runners, net)
    drive(runners, SIZES["desync_offset_frame"], net)
    if any(desyncs(r) for r in runners):
        raise SystemExit("chip_smoke: DesyncDetected before the offset")
    r0 = runners[0]
    w = r0.world
    r0.world = dataclasses.replace(w, comps={**w.comps, "pos": w.comps["pos"] + 0.5})
    r0._world_checksum = wrap_single_checksum(r0.app.checksum_fn(r0.world))
    start = r0.frame
    while not any(desyncs(r) for r in runners):
        if r0.frame - start >= SIZES["desync_window"]:
            raise SystemExit("chip_smoke: no DesyncDetected within "
                             f"{SIZES['desync_window']} frames of the offset")
        drive(runners, 1, net)
    first = min((e for r in runners for e in desyncs(r)), key=lambda e: e.frame)
    return {"offset_at_frame": start, "detected_at_frame": first.frame,
            "frames_to_detect": r0.frame - start,
            "local_checksum": hex(first.local_checksum),
            "remote_checksum": hex(first.remote_checksum)}


P2P_RATES: dict = {}  # pair -> frames/s per peer over the ChannelNetwork (phase p2p)


def phase_p2p(dev) -> int:
    """Three pairs on the card, the forced desync, and fixed_point's
    confirmed checksums on the card against the CPU's."""
    from bevy_ggrs_tpu_torch.models import box_game, fixed_point, stress_soa

    n = SIZES["p2p_stress_entities"]
    pairs = {
        f"stress_soa_{n}": lambda: stress_soa.make_app(n_entities=n, device=dev),
        "box_game": lambda: box_game.make_app(device=dev),
        "fixed_point": lambda: fixed_point.make_app(device=dev),
    }
    launches = 0
    fixed_on_card = None
    for seed, (name, make_app) in enumerate(pairs.items()):
        result = p2p_run(name, make_app, dev, seed)
        launches += result["fold_launches"]
        agreed = result.pop("agreed")
        if name == "fixed_point":
            fixed_on_card = agreed
        P2P_RATES[name] = result["frames_per_s_per_peer"]
        emit("p2p", **result)
    emit("p2p_desync", model="box_game", **forced_desync(dev))
    cpu = p2p_run("fixed_point", lambda: fixed_point.make_app(device="cpu"),
                  torch.device("cpu"), 2)["agreed"]
    shared = [f for f in fixed_on_card if f in cpu and f <= SIZES["p2p_cpu_parity_frame"]]
    if not shared:
        raise SystemExit("chip_smoke: no confirmed fixed_point frame on both devices")
    frame = max(shared)
    if fixed_on_card[frame] != cpu[frame] or any(fixed_on_card[f] != cpu[f] for f in shared):
        raise SystemExit(f"chip_smoke: fixed_point's confirmed checksum at frame {frame} "
                         f"differs between {dev} and cpu")
    emit("p2p_parity", model="fixed_point", frame=frame, checksum=hex(cpu[frame]),
         frames_compared=len(shared), card_equals_cpu=True)
    return launches


def phase_spectator(dev) -> int:
    """A box_game host pair streaming to a port spectator on the card."""
    from bevy_ggrs_tpu_torch import GgrsRunner, SessionBuilder
    from bevy_ggrs_tpu_torch.models import box_game
    from bevy_ggrs_tpu_torch.ops import checksum_fold as cf
    from bevy_ggrs_tpu_torch.session.channel import ChannelNetwork

    net = ChannelNetwork(latency_hops=SIZES["p2p_latency_hops"], loss=0.0, seed=4)
    socks = [net.endpoint(a) for a in ("p0", "p1", "spec")]
    hosts = [p2p_peer(lambda: box_game.make_app(device=dev), i, socks[i], f"p{1 - i}",
                      spectator="spec" if i == 0 else None) for i in range(2)]
    host_checks = record_confirmed(hosts[0])
    app = box_game.make_app(device=dev)
    spec = GgrsRunner(app, SessionBuilder.for_app(app).start_spectator_session("p0", socks[2]))
    everyone = hosts + [spec]
    sync_sessions(everyone, net)
    kept = keep_stacks(everyone)
    frames = SIZES["spectator_frames"]
    sync(dev)
    cf.launches = 0
    matched = 0
    t0 = time.perf_counter()
    for _ in range(frames):
        drive(everyone, 1, net)
        if spec.frame in host_checks:
            if spec.checksum != host_checks[spec.frame]():
                raise SystemExit(f"chip_smoke: the spectator's checksum at frame "
                                 f"{spec.frame} differs from the host's")
            matched += 1
    sync(dev)
    dt = time.perf_counter() - t0
    launches = cf.launches
    resims = sum(r.resims for r in everyone)
    if spec.session.current_state().value != "running" or spec.frame < frames - 20 \
            or matched < frames // 2 or (dev.type == "cuda" and launches != resims):
        raise SystemExit(f"chip_smoke: the spectator fell out of step: frame "
                         f"{spec.frame}, {matched} frames matched, {launches} launches "
                         f"for {resims} resims")
    stack_shapes = check_stacks("spectator", kept)
    emit("spectator", model="box_game", frames=frames, seconds=dt,
         spectator_frame=spec.frame, host_frames=[h.frame for h in hosts],
         frames_matched_host=matched, spectator_resims=spec.resims,
         spectator_stalls=spec.stalled_frames, fold_launches=launches,
         resim_calls=resims, desyncs=[len(desyncs(h)) for h in hosts],
         path_stacks_bit_exact=stack_shapes)
    return launches


def phase_native(dev) -> int:
    """A port native-core peer (handle 1) against a port Python peer
    (handle 0, whose input flips) over loopback UDP at input delay 0.  The
    native peer steps first in each tick, on a clock 10% fast that its
    run-slow (x1.1) holds level with the Python peer, so it advances each
    frame before the Python peer has sent that frame's input: it predicts,
    mispredicts at each flip and serves the core's LoadRequests."""
    from bevy_ggrs_tpu_torch import UdpNonBlockingSocket
    from bevy_ggrs_tpu_torch.models import fixed_point
    from bevy_ggrs_tpu_torch.ops import checksum_fold as cf

    sock = UdpNonBlockingSocket(0, host="127.0.0.1")
    try:
        def make_app():
            return fixed_point.make_app(device=dev)
        nat = p2p_peer(make_app, 1, None, ("127.0.0.1", sock.local_addr[1]),
                       native_port=0, input_delay=0)
        py = p2p_peer(make_app, 0, sock, ("127.0.0.1", nat.session.local_port()),
                      input_delay=0)
        runners = [nat, py]
        seen = [record_confirmed(r) for r in runners]
        sync_sessions(runners, sleep_s=0.001)
        kept = keep_stacks(runners)
        frames = SIZES["native_frames"]
        sync(dev)
        cf.launches = 0
        t0 = time.perf_counter()
        for _ in range(frames):
            nat.update(1.1 / 60.0)
            py.update(1.0 / 60.0)
        sync(dev)
        dt = time.perf_counter() - t0
        launches = cf.launches
        resims = sum(r.resims for r in runners)
        for r in runners:
            r.finish()
        agreed = agreed_checksums(seen)
    finally:
        sock.close()
    if any(desyncs(r) for r in runners) or len(agreed) < frames // 2 \
            or min(r.frame for r in runners) < frames - 10 \
            or nat.rollbacks == 0 or set(nat.rollbacks_by_cause) != {0} \
            or (dev.type == "cuda" and launches != resims):
        raise SystemExit(f"chip_smoke: native pair out of sync or never rolled "
                         f"back: frames {[r.frame for r in runners]}, rollbacks "
                         f"{[r.rollbacks for r in runners]}, {len(agreed)} agreed, "
                         f"{launches} launches for {resims} resims")
    stack_shapes = check_stacks("native", kept)
    emit("native", model="fixed_point", frames=frames, seconds=dt, input_delay=0,
         sessions=[type(r.session).__name__ for r in runners],
         final_frames=[r.frame for r in runners], rollbacks=[r.rollbacks for r in runners],
         resimulated_frames=[r.rollback_frames for r in runners],
         rollbacks_by_cause=[{str(h): n for h, n in r.rollbacks_by_cause.items()}
                             for r in runners],
         confirmed_frames_agreed=len(agreed), fold_launches=launches, resim_calls=resims,
         desyncs=[len(desyncs(r)) for r in runners], path_stacks_bit_exact=stack_shapes)
    return launches


# -- telemetry: the registry, phases, flight ring, trace, devmem, forensics ------


def warm_profile(step, calls: int):
    """A ``torch.profiler`` trace of ``calls`` calls of ``step`` behind one
    traced and discarded warm-up call (the schedule's ``warmup``), each end
    of the counted calls at a device sync; returns the profiler and the
    counted calls' wall ms.  A trace that starts with the counted calls
    loses records at its start: on the H100
    (``scripts/torch_profile_windows.py``), twenty plain windows of the
    same 10 lobby chunks read 8,171 to 8,180 kernels and 9 or 10 uploads;
    19 of twenty behind a warm-up call read all 8,180 and 10."""
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=calls, repeat=1)) as prof:
        step()
        torch.cuda.synchronize()
        prof.step()
        t0 = time.perf_counter()
        for i in range(calls):
            step()
            if i == calls - 1:
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
            prof.step()
    return prof, wall_ms


def tick_events(step, ticks: int) -> dict:
    """Kernels, copies and fills in a profiled window of ``ticks`` calls of
    ``step`` (behind a warm-up call, :func:`warm_profile`): the totals,
    and per call."""
    sync(torch.device("cuda"))
    prof, _ = warm_profile(step, ticks)
    counts = {"kernels": 0, "copies": 0, "fills": 0}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA \
                or getattr(e, "is_user_annotation", False) or e.key.startswith("ProfilerStep"):
            continue
        kind = "copies" if "Memcpy" in e.key else "fills" if "Memset" in e.key else "kernels"
        counts[kind] += e.count
    return {**counts, **{f"{k}_per_tick": v / ticks for k, v in counts.items()}}


def same_events(on: dict, off: dict) -> bool:
    """The same kernels, copies and fills in two windows of the same ticks,
    up to one record of each kind: the profiler can drop a record at a
    window's edge (phase ``pipeline`` sees one tick's copy go missing), and
    a seam that added work would add it on every tick of the window."""
    return all(abs(on[k] - off[k]) <= 1 for k in ("kernels", "copies", "fills"))


def telemetry_mode(on: bool, flight: bool = True) -> None:
    """Fresh registry, timeline, flight ring and devmem rows; telemetry
    and the flight ring on or off; net stats at their default cadence."""
    from bevy_ggrs_tpu_torch import telemetry

    telemetry.reset()
    telemetry.configure_forensics(None)
    telemetry.configure_flight(maxlen=256, enabled=flight)
    (telemetry.enable if on else telemetry.disable)()


class TickClock:
    """A virtual protocol clock (``session/protocol.now_s`` and
    ``session/p2p.now_s``) that moves one frame per call of a network's
    ``deliver``: the protocol's timers then fire at the same ticks however
    long a tick takes on the host, so two runs of one pair, telemetry on
    and off, play the same game tick for tick (on the wall clock a slower
    tick reorders keep-alives and quality reports, and with them the
    rollbacks)."""

    def __init__(self, net):
        from bevy_ggrs_tpu_torch.session import p2p, protocol

        self._mods = (p2p, protocol)
        self._saved = [m.now_s for m in self._mods]
        self._net, self._deliver = net, net.deliver
        self.t = 1000.0
        for m in self._mods:
            m.now_s = lambda: self.t

        def deliver():
            self.t += 1 / 60.0
            self._deliver()

        net.deliver = deliver

    def close(self) -> None:
        for m, f in zip(self._mods, self._saved):
            m.now_s = f
        self._net.deliver = self._deliver


class Scraper:
    """Scrapes ``/metrics`` and ``/qos`` of an exporter on 127.0.0.1 from a
    thread while the main loop runs; counts the answers that parsed."""

    def __init__(self, port: int):
        import threading

        self.port, self.ok, self.errors = port, {"/metrics": 0, "/qos": 0}, []
        self.rollbacks_seen = False
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        import urllib.request

        while not self._stop.is_set():
            for path in ("/metrics", "/qos"):
                try:
                    body = urllib.request.urlopen(f"http://127.0.0.1:{self.port}{path}",
                                                  timeout=5).read().decode()
                    if path == "/qos":
                        json.loads(body)["lobby_qos_score"]
                    elif "rollbacks_total" in body:
                        self.rollbacks_seen = True
                    self.ok[path] += 1
                except Exception as e:  # noqa: BLE001 - counted, checked by the caller
                    self.errors.append(repr(e))
            # a scraper's pace, not a busy loop: every scrape renders the
            # registry in Python and holds the GIL the runners tick on
            self._stop.wait(0.25)

    def stop(self) -> dict:
        self._stop.set()
        self._thread.join(timeout=10)
        return {"answers": dict(self.ok), "errors": self.errors[:3],
                "rollbacks_seen": self.rollbacks_seen}


def peer_traces(events: list, ticks: list) -> list:
    """Each peer's own trace, as two processes would write theirs: peer
    ``i``'s input sends carry its handle, its rollbacks blame the other's."""
    from bevy_ggrs_tpu_torch import telemetry

    out = []
    for i in range(2):
        own = [e for e in events if (e["kind"] == "input_send" and e["handles"] == [i])
               or (e["kind"] == "rollback" and e["handle"] == 1 - i)]
        out.append(telemetry.chrome_trace(own, ticks, pid=1 + i))
    return out


def telemetry_pair(name: str, make_app, dev, seed: int, on: bool) -> dict:
    """Phase 8's pair with telemetry on or off (the flight ring on at its
    default): the loop under sync debug "error", a profiled window, and
    with telemetry on the registry, phase, devmem, trace and exporter
    checks; fails on any of them."""
    from bevy_ggrs_tpu_torch import telemetry
    from bevy_ggrs_tpu_torch.ops import checksum_fold as cf
    from bevy_ggrs_tpu_torch.telemetry import devmem

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    telemetry_mode(on)
    net, runners, seen = channel_pair(make_app, seed)
    clock = TickClock(net)
    sync_sessions(runners, net)
    exporter = telemetry.start_http_exporter(port=0, host="127.0.0.1") if on else None
    scraper = Scraper(exporter.port) if on else None
    frames = SIZES["p2p_frames"]
    before = counters(runners)
    sync(dev)
    cf.launches = 0
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        drive(runners, frames, net)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    host_s = time.perf_counter() - t0
    sync(dev)
    launches = cf.launches
    loop = {k: v - before[k] for k, v in counters(runners).items()}
    served = scraper.stop() if on else None
    if on:
        exporter.close()
    # consecutive profiled windows, each with the game it played: two runs
    # of one pair have placed a window's rollback a tick apart on the card
    # though their loops matched (cause not found)
    windows = []
    for _ in range(SIZES["telemetry_profile_windows"]):
        start = counters(runners)
        events = tick_events(lambda: drive(runners, 1, net), SIZES["telemetry_profile_ticks"])
        end = counters(runners)
        windows.append({"events": events, "game": {k: end[k] - start[k] for k in WINDOW_GAME}})
    out = {"pair": name, "telemetry": on, "frames": frames,
           "host_ms_per_peer_tick": host_s * 1e3 / (2 * frames), "loop": loop,
           "fold_launches": launches, "profile": windows[0]["events"],
           "profile_windows": windows,
           "desyncs": [len(desyncs(r)) for r in runners]}
    fail = []
    if launches != loop["resims"]:
        fail.append(f"{launches} fold launches for {loop['resims']} resims")
    if loop["forced"] or loop["staging_deferred_blocks"]:
        fail.append("the loop waited for the card")
    if any(out["desyncs"]) or loop["rollbacks"] == 0:
        fail.append("a desync or no rollback")
    if on:
        snap = telemetry.registry().snapshot()
        total = sum(snap["rollbacks_total"]["series"].values())
        causes = snap["rollback_cause_total"]["series"]
        out["rollbacks_total"], out["rollback_cause_total"] = total, causes
        if total != sum(causes.values()) or total != sum(r.rollbacks for r in runners):
            fail.append(f"rollback_cause_total {causes} against rollbacks_total {total}")
        out["phases"] = [r.stats()["phases"] for r in runners]
        for t in out["phases"]:
            attributed = sum(t["phase_seconds"].values())
            if abs(t["wall_seconds"] - attributed - t["unattributed_seconds"]) > 1e-4 \
                    or t["unattributed_pct"] > SIZES["telemetry_unattributed_max_pct"]:
                fail.append(f"phase totals: {t}")
        gc.collect()
        rows = devmem.snapshot()
        out["census"] = devmem.census(strict=True)
        out["census"].pop("owners")
        for r in runners:
            want = len(r.ring.frames()) * r._world_nbytes
            got = rows.get(r._devmem_tag + "/snapshot_ring")
            if got != want:
                fail.append(f"devmem ring row {got} != {want}")
        trace = telemetry.chrome_trace()
        merged = telemetry.merge_traces(*peer_traces(telemetry.timeline().events(),
                                                     telemetry.flight_recorder().snapshot()))
        problems = telemetry.validate_chrome_trace(trace) + \
            telemetry.validate_chrome_trace(merged)
        links = telemetry.flows(merged)
        out["trace"] = {"events": len(trace["traceEvents"]), "merged_flows": len(links),
                        "aligned_frames": merged["metadata"]["aligned_frames"]}
        if problems or not links:
            fail.append(f"trace: {problems[:3]}, {len(links)} cross-peer flows")
        out["exporter"] = served
        if not (served["answers"]["/metrics"] and served["answers"]["/qos"]
                and served["rollbacks_seen"]) or served["errors"]:
            fail.append(f"exporter: {served}")
    for r in runners:
        r.finish()
    clock.close()
    out["agreed"] = agreed_checksums(seen)
    if fail:
        raise SystemExit(f"chip_smoke: telemetry {name} (on={on}): {'; '.join(fail)}: {out}")
    return out


def plain_component_checksums(reg, world) -> dict:
    """``telemetry.forensics.component_checksums`` through the fold's plain
    version: every part from ``checksum_fold_plain`` and torch ops."""
    from bevy_ggrs_tpu_torch.ops import checksum_fold as cf
    from bevy_ggrs_tpu_torch.snapshot.checksum import (
        SEEDS,
        _resource_parts,
        _stack1,
        fold_inputs,
    )

    stacked = _stack1(world)
    names = [n for n, s in reg.components.items() if s.checksum]
    res = [n for n, s in reg.resources.items() if s.checksum]
    rows = [cf.checksum_fold_plain(*fold_inputs(reg, stacked, names, SEEDS))[0, 1:]]
    rows += [torch.stack([_resource_parts(reg, stacked, n, s)[0] for s in SEEDS])[None]
             for n in res]
    rows.append(cf.checksum_fold_plain(*fold_inputs(None, stacked, [], SEEDS))[0, :1])
    keys = names + ["res:" + n for n in res] + ["__entities__"]
    return {k: (int(hi) << 32) | int(lo)
            for k, (hi, lo) in sorted(zip(keys, torch.cat(rows).cpu().tolist()))}


def forensics_pair(dev) -> dict:
    """Part (b): ``forced_desync``'s box_game pair with a forensics
    directory per peer (as two processes would have), outside sync debug
    "error": both peers write a report, each report's per-component parts
    equal the fold's plain version on the same world and the CPU
    computation on a copy of it, and the merge of the two reports names
    the first divergent frame and ``pos``.  The forensics fold's stacks are
    kept and held to the plain fold after the count is read."""
    import tempfile

    from bevy_ggrs_tpu_torch import telemetry
    from bevy_ggrs_tpu_torch.models import box_game
    from bevy_ggrs_tpu_torch.ops import checksum_fold as cf
    from bevy_ggrs_tpu_torch.snapshot import checksum as snap_cs
    from bevy_ggrs_tpu_torch.snapshot.lazy import wrap_single_checksum
    from bevy_ggrs_tpu_torch.telemetry import forensics
    from bevy_ggrs_tpu_torch.utils.tree import tree_map

    telemetry_mode(True)
    calls, stacks = [], []
    inside = [False]
    original = forensics.component_checksums
    fold_mod, fold_snap = cf.checksum_fold, snap_cs.checksum_fold

    def keeping_fold(fn):
        def fold(*args):
            if inside[0]:
                stacks.append(args)
            return fn(*args)
        return fold

    def timed(reg, world):
        inside[0] = True
        t0 = time.perf_counter()
        try:
            got = original(reg, world)
        finally:
            inside[0] = False
        calls.append({"reg": reg, "world": world, "got": got,
                      "ms": (time.perf_counter() - t0) * 1e3})
        return got

    dirs = [tempfile.mkdtemp(prefix=f"forensics_p{i}_") for i in range(2)]
    forensics.component_checksums = timed
    cf.checksum_fold = keeping_fold(fold_mod)
    snap_cs.checksum_fold = keeping_fold(fold_snap)
    try:
        net, runners, _ = channel_pair(lambda: box_game.make_app(device=dev), seed=3)
        sync_sessions(runners, net)

        def step():
            net.deliver()
            for d, r in zip(dirs, runners):
                telemetry.configure_forensics(d)  # each peer's own directory
                r.update(1 / 60.0)

        for _ in range(SIZES["desync_offset_frame"]):
            step()
        r0 = runners[0]
        w = r0.world
        r0.world = dataclasses.replace(w, comps={**w.comps, "pos": w.comps["pos"] + 0.5})
        r0._world_checksum = wrap_single_checksum(r0.app.checksum_fn(r0.world))
        start = r0.frame
        sync(dev)
        cf.launches = 0
        while not all(desyncs(r) for r in runners):
            if r0.frame - start >= SIZES["desync_window"]:
                raise SystemExit("chip_smoke: telemetry forensics: no DesyncDetected on "
                                 f"both peers within {SIZES['desync_window']} frames")
            step()
        sync(dev)
        launches = cf.launches
    finally:
        forensics.component_checksums = original
        cf.checksum_fold, snap_cs.checksum_fold = fold_mod, fold_snap
        telemetry.configure_forensics(None)
    reports = [sorted(Path(d).glob("desync_p2p_desync_*.json")) for d in dirs]
    fail = []
    if not all(reports):
        fail.append(f"reports per peer: {[len(r) for r in reports]}")
    for c in calls:
        cpu_world = tree_map(lambda a: a.cpu(), c["world"])
        if c["got"] != plain_component_checksums(c["reg"], c["world"]) \
                or c["got"] != forensics.component_checksums(c["reg"], cpu_world):
            fail.append("a report's component checksums differ from the plain fold's "
                        "or the CPU's")
    # two reports of one peer in one millisecond share a file name: every
    # file holds one of the computed sets
    computed = {json.dumps(c["got"]) for c in calls}
    if any(json.dumps(json.loads(p.read_text())["component_checksums"]) not in computed
           for ps in reports for p in ps):
        fail.append("a report does not hold the computed component checksums")
    merged = telemetry.merge_reports(str(reports[0][0]), str(reports[1][0])) \
        if all(reports) else {}
    first = merged.get("first_divergent_frame")
    if first is None or first < start or "pos" not in (merged.get("component_diff") or []):
        fail.append(f"merge: first divergent frame {first}, components "
                    f"{merged.get('component_diff')}")
    # the fold on the forensics stacks (k = 1, C components, both seeds),
    # after the count was read: these launches are not the path's
    for args in stacks:
        if not torch.equal(cf.checksum_fold(*args), cf.checksum_fold_plain(*args)):
            fail.append("checksum_fold disagrees with its plain version on a forensics stack")
            break
    out = {"model": "box_game", "offset_at_frame": start,
           "first_divergent_frame": first, "component_diff": merged.get("component_diff"),
           "reports": [len(r) for r in reports], "component_checksum_calls": len(calls),
           "fold_launches": launches,
           "forensics_fold_launches_per_report": len(stacks) / len(calls) if calls else None,
           "forensics_read_ms": sorted(c["ms"] for c in calls),
           "forensics_stacks": sorted({tuple(a[2].shape) + (len(a[0]),) for a in stacks})}
    if fail:
        raise SystemExit(f"chip_smoke: telemetry forensics: {'; '.join(fail)}: {out}")
    return out


def server_telemetry(dev, on: bool) -> dict:
    """Part (c): phase ``batched`` (c)'s stress_soa pairs as one
    BatchedRunner for ``telemetry_server_ticks`` ticks, telemetry on or
    off: confirmed checksum refs, kernels per steady tick, and with
    telemetry on the per-lobby labels, the QoS scores of every lobby and
    the devmem rows of the worlds and the rings."""
    from bevy_ggrs_tpu_torch import BatchedRunner, telemetry
    from bevy_ggrs_tpu_torch.models import stress_soa
    from bevy_ggrs_tpu_torch.ops import checksum_fold as cf
    from bevy_ggrs_tpu_torch.telemetry import devmem
    from bevy_ggrs_tpu_torch.utils.mem import tree_device_bytes

    gc.collect()
    torch.cuda.empty_cache()
    telemetry_mode(on)

    def make(d):
        return stress_soa.make_app(n_entities=SIZES["server_entities"], device=d)

    nets, sessions = pair_sessions(lambda: make(dev), dev, SIZES["server_pairs"], seed=40)
    clock = TickClock(nets[0])  # the first pair's delivery moves every pair's clock
    br = BatchedRunner(make(dev), sessions,
                       read_inputs=lambda b, hs: {h: pair_inputs(br.frames[b], b) for h in hs})
    sync_all(nets, br.tick, sessions)
    seen = [{} for _ in sessions]

    def tick():
        for net in nets:
            net.deliver()
        br.tick()
        note_confirmed(br.rings, br.confirmed, seen)

    sync(dev)
    cf.launches = 0
    for _ in range(SIZES["telemetry_server_ticks"]):
        tick()
    sync(dev)
    launches = cf.launches
    events = tick_events(tick, SIZES["telemetry_profile_ticks"])
    clock.close()
    m = len(sessions)
    out = {"model": "stress_soa", "entities": SIZES["server_entities"], "lobbies": m,
           "telemetry": on, "ticks": SIZES["telemetry_server_ticks"], "fold_launches": launches,
           "profile": events, "rollbacks": br.rollbacks,
           "desyncs": sum(type(e).__name__ == "DesyncDetected" for _b, e in br.events)}
    fail = []
    if out["desyncs"] or not br.rollbacks:
        fail.append("a desync or no rollback")
    if on:
        snap = telemetry.registry().snapshot()
        lobbies = {dict(kv.split("=") for kv in key.split(","))["lobby"]
                   for key in snap["rollbacks_total"]["series"]}
        qos = telemetry.qos_snapshot()["lobby_qos_score"]
        rows = devmem.snapshot()
        tag = br._devmem_tag
        ring_rows = [rows.get(f"{tag}/ring{b}") for b in range(m)]
        row_bytes = tree_device_bytes(br.worlds) // m
        out.update(lobbies_labelled=len(lobbies), qos_lobbies=len(qos),
                   worlds_row=rows.get(tag + "/worlds"),
                   ring_rows=sum(x is not None for x in ring_rows))
        if len(lobbies) != m or set(qos) != {str(b) for b in range(m)}:
            fail.append(f"lobby labels {sorted(lobbies)}, QoS lobbies {sorted(qos)}")
        if rows.get(tag + "/worlds") != tree_device_bytes(br.worlds) or any(
                x != len(br.rings[b].frames()) * row_bytes for b, x in enumerate(ring_rows)):
            fail.append("devmem rows of the worlds or the rings")
    if fail:
        raise SystemExit(f"chip_smoke: telemetry server (on={on}): {'; '.join(fail)}: {out}")
    out["confirmed"] = seen
    return out


def telemetry_cost(dev) -> dict:
    """Part (e), printed and not gated: host ms per peer tick of phase 8's
    stress_soa 1M pair in three arms taken in turns on each of
    ``telemetry_cost_pairs`` fresh pairs (the order rotated per pair):
    telemetry and the flight ring off; the flight ring only (the default);
    telemetry on."""
    from bevy_ggrs_tpu_torch.models import stress_soa

    arms = {"off": (False, False), "flight_only": (False, True), "on": (True, True)}
    ms = {a: [] for a in arms}
    n = SIZES["p2p_stress_entities"]
    frames = SIZES["telemetry_cost_frames"]
    order = list(arms)
    for p in range(SIZES["telemetry_cost_pairs"]):
        gc.collect()
        torch.cuda.empty_cache()
        telemetry_mode(False)
        net, runners, _ = channel_pair(lambda: stress_soa.make_app(n_entities=n, device=dev),
                                       seed=10 + p)
        sync_sessions(runners, net)
        drive(runners, 10, net)  # the first dispatch of each depth
        for arm in order[p % 3:] + order[:p % 3]:
            on, flight = arms[arm]
            telemetry_mode(on, flight)
            sync(dev)
            t0 = time.perf_counter()
            drive(runners, frames, net)
            ms[arm].append((time.perf_counter() - t0) * 1e3 / (2 * frames))
        del net, runners
    telemetry_mode(False)
    med = {a: statistics.median(v) for a, v in ms.items()}
    return {"pairs": SIZES["telemetry_cost_pairs"], "frames_per_arm": frames,
            "host_ms_per_peer_tick": ms, "median": med,
            "spread": {a: (max(v) - min(v)) / med[a] for a, v in ms.items()},
            "on_minus_off_ms": med["on"] - med["off"],
            "flight_minus_off_ms": med["flight_only"] - med["off"]}


def phase_telemetry(dev, card: str) -> int:
    """The telemetry package on the card, parts (a) to (e) of the module
    docstring; returns the fold launches of the driven paths (the pairs
    with telemetry on, the forensics pair, the server with telemetry on,
    the speculation pair)."""
    from bevy_ggrs_tpu_torch import SpeculationConfig, pad_candidates, telemetry
    from bevy_ggrs_tpu_torch.models import fixed_point, stress_soa

    n = SIZES["p2p_stress_entities"]
    pairs = {f"stress_soa_{n}": lambda: stress_soa.make_app(n_entities=n, device=dev),
             "fixed_point": lambda: fixed_point.make_app(device=dev)}
    launches = 0
    for seed, (name, make_app) in enumerate(pairs.items()):
        off = telemetry_pair(name, make_app, dev, seed, on=False)
        on = telemetry_pair(name, make_app, dev, seed, on=True)
        a, b = on.pop("agreed"), off.pop("agreed")
        shared = sorted(set(a) & set(b))
        if len(shared) < SIZES["p2p_frames"] // 2 or any(a[f] != b[f] for f in shared):
            raise SystemExit(f"chip_smoke: telemetry {name}: confirmed checksums differ "
                             f"with telemetry on and off ({len(shared)} shared frames)")
        game = ("resims", "frames", "rollbacks")
        if [on["loop"][k] for k in game] != [off["loop"][k] for k in game]:
            raise SystemExit(f"chip_smoke: telemetry {name}: the runs on and off played "
                             f"different games: {on['loop']} against {off['loop']}")
        # the first window in which both runs played the same game must
        # show the same device events
        won, woff = on.pop("profile_windows"), off.pop("profile_windows")
        same = [(x, y) for x, y in zip(won, woff) if x["game"] == y["game"]]
        if not same or not same_events(same[0][0]["events"], same[0][1]["events"]):
            raise SystemExit(f"chip_smoke: telemetry {name}: no window of the same game, or "
                             f"its device events differ: on {won}, off {woff}")
        on["profile"], on["profile_game"] = same[0][0]["events"], same[0][0]["game"]
        launches += on["fold_launches"]
        emit("telemetry_pair", card=card, frames_agreed_on_off=len(shared),
             host_ms_per_peer_tick_off=off["host_ms_per_peer_tick"], **on)
    r = forensics_pair(dev)
    launches += r["fold_launches"]
    emit("telemetry_forensics", card=card, **r)
    off, on = server_telemetry(dev, False), server_telemetry(dev, True)
    shared = 0
    for lobby, (x, y) in enumerate(zip(on.pop("confirmed"), off.pop("confirmed"))):
        frames = set(x) & set(y)
        if len(frames) < SIZES["telemetry_server_ticks"] // 2 or any(x[f]() != y[f]()
                                                                      for f in frames):
            raise SystemExit(f"chip_smoke: telemetry server: lobby {lobby}'s confirmed "
                             "checksums differ with telemetry on and off")
        shared += len(frames)
    if not same_events(on["profile"], off["profile"]):
        raise SystemExit(f"chip_smoke: telemetry server: device events per tick differ "
                         f"on {on['profile']} and off {off['profile']}")
    launches += on["fold_launches"]
    emit("telemetry_server", card=card, frames_agreed_on_off=shared,
         profile_off=off["profile"], **on)
    telemetry_mode(True)
    svc = service_pair(dev, SpeculationConfig(
        candidates_fn=pad_candidates(2, [0, 1], [0, 1]), depth=SIZES["spec_depth"],
        max_cached_frames=16))
    snap = telemetry.registry().snapshot()
    fams = {key: sum(snap.get(fam, {"series": {}})["series"].values())
            for key, fam in (("hits", "speculation_hits_total"),
                             ("misses", "speculation_misses_total"),
                             ("drafts", "draft_dispatches_total"))}
    if fams != svc["census"] or not fams["hits"]:
        raise SystemExit(f"chip_smoke: telemetry speculation families {fams} against "
                         f"the caches' counters {svc['census']}")
    launches += svc["fold_launches"]
    emit("telemetry_speculation", card=card, families=fams, caches=svc["census"],
         hit_rate=svc["hit_rate"], fold_launches=svc["fold_launches"])
    emit("telemetry_cost", card=card, **telemetry_cost(dev))
    telemetry_mode(False)
    return launches


# -- the runner's dispatch modes ---------------------------------------------------

MODES = {  # the runner's defaults (pipelined, packed, donating) and the sync baseline
    "pipelined": {},
    "sync": {"pipeline": False, "packed": False},
}


# the counters that say which game a profiled window played
WINDOW_GAME = ("resims", "frames", "rollbacks", "rollback_frames", "materialized_saves")


def counters(runners) -> dict:
    """The runners' counters summed over the pair."""
    out = {"resims": 0, "frames": 0, "rollback_frames": 0, "forced": 0, "peek_misses": 0,
           "harvested": 0}
    for r in runners:
        st = r.stats()
        out["resims"] += r.resims
        out["frames"] += r.frame
        out["rollback_frames"] += r.rollback_frames
        for key in ("forced", "peek_misses", "harvested"):
            out[key] += st["readbacks"][key]
        for key in ("pipeline_degrades", "materialized_saves", "donated_dispatches",
                    "host_uploads", "packed_upload_bytes", "staging_deferred_blocks",
                    "staging_landed_free", "rollbacks", "megastep_dispatches",
                    "fused_ring_loads"):
            out[key] = out.get(key, 0) + st[key]
    return out


def copy_counts(prof):
    """A profiler trace's host-to-device copies (pinned, pageable),
    device-to-host copies and kernel launches, and its device busy µs
    (kernels, copies and fills)."""
    counts = {"htod": 0, "htod_pinned": 0, "htod_pageable": 0, "dtoh": 0, "launches": 0}
    busy_us = 0.0
    for e in prof.key_averages():
        # kernels, copies and fills only: a user annotation's device range
        # spans the kernels inside it and would count them twice
        if e.device_type != torch.autograd.DeviceType.CUDA \
                or getattr(e, "is_user_annotation", False) \
                or e.key.startswith("ProfilerStep"):
            continue
        busy_us += next((float(getattr(e, a)) for a in ("self_device_time_total",
                                                        "self_cuda_time_total")
                         if hasattr(e, a)), 0.0)
        if "HtoD" in e.key:
            counts["htod"] += e.count
            counts["htod_pinned"] += e.count if "Pinned" in e.key else 0
            counts["htod_pageable"] += e.count if "Pageable" in e.key else 0
        elif "DtoH" in e.key:
            counts["dtoh"] += e.count
        elif "Memcpy" not in e.key and "Memset" not in e.key:
            counts["launches"] += e.count
    return counts, busy_us


def profile_ticks(runners, net, ticks: int, step: int = 1) -> dict:
    """A profiler trace of ``ticks`` pair ticks: host-to-device copies per
    resim (pinned and pageable), device-to-host copies and kernel launches
    per peer tick, device busy time (kernels, copies and fills) and the
    idle share; a busy time beyond the window's wall time fails."""
    from torch.profiler import ProfilerActivity, profile

    resims0 = sum(r.resims for r in runners)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        drive(runners, ticks, net, step)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    resims = sum(r.resims for r in runners) - resims0
    counts, busy_us = copy_counts(prof)
    peer_ticks = 2 * ticks
    if not 0 < busy_us / 1e3 <= wall_ms:
        # the copy stream overlaps the compute stream by microseconds at
        # most; a busy time beyond the wall time is a counting error
        raise SystemExit(f"chip_smoke: profiled device busy time {busy_us / 1e3} ms "
                         f"is not within the window's {wall_ms} ms")
    return {"profiled_peer_ticks": peer_ticks, "profiled_resims": resims, **counts,
            "htod_per_resim": counts["htod"] / resims if resims else None,
            "pinned_htod_per_resim": counts["htod_pinned"] / resims if resims else None,
            "dtoh_per_peer_tick": counts["dtoh"] / peer_ticks,
            "launches_per_peer_tick": counts["launches"] / peer_ticks,
            "host_ms_per_peer_tick": wall_ms / peer_ticks,
            "device_busy_ms_per_peer_tick": busy_us / 1e3 / peer_ticks,
            "idle_share": 1 - busy_us / 1e3 / wall_ms if wall_ms else None}


def pipeline_run(name: str, make_app, dev, seed: int, mode: str) -> dict:
    """One P2P pair in one dispatch mode: warm-up, a timed steady loop (the
    pipelined one under ``set_sync_debug_mode("error")``), a profiled
    window, then the checks: one fold launch per resim, no desync, and for
    the pipelined mode no forced readback and no staging wait in the loop,
    one pinned upload per resim and none from pageable memory."""
    from bevy_ggrs_tpu_torch.ops import checksum_fold as cf

    cuda = dev.type == "cuda"
    if cuda:
        gc.collect()  # earlier runs' runners sit in reference cycles
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    net, runners, seen = channel_pair(make_app, seed, **MODES[mode])
    sync_sessions(runners, net)
    kept = keep_stacks(runners)
    drive(runners, SIZES["pipeline_warmup_frames"], net)
    frames = SIZES["pipeline_frames"]
    before = counters(runners)
    sync(dev)
    cf.launches = 0
    debug = cuda and mode == "pipelined"
    t0 = time.perf_counter()
    if debug:
        torch.cuda.set_sync_debug_mode("error")
    try:
        drive(runners, frames, net)
    finally:
        if debug:
            torch.cuda.set_sync_debug_mode("default")
    host_s = time.perf_counter() - t0
    sync(dev)
    dt = time.perf_counter() - t0
    launches = cf.launches
    after = counters(runners)
    loop = {k: after[k] - before[k] for k in after}
    prof = profile_ticks(runners, net, SIZES["pipeline_profile_frames"]) if cuda else {}
    peak = torch.cuda.max_memory_allocated(dev) if cuda else None
    for r in runners:
        r.finish()
    agreed = agreed_checksums(seen)
    stack_shapes = check_stacks(f"{name}/{mode}", kept) if cuda else []
    result = {
        "pair": name, "mode": mode, "device": str(dev), "frames": frames,
        "sync_debug_mode": "error" if debug else "default",
        "seconds": dt, "host_seconds_of_loop": host_s,
        "frames_per_s_per_peer": loop["frames"] / 2 / dt,
        "packed": runners[0].packed, "pipeline": runners[0].pipeline,
        "loop": loop, "fold_launches": launches,
        "launches_per_resim": launches / loop["resims"] if loop["resims"] else None,
        "desyncs": [len(desyncs(r)) for r in runners],
        "max_memory_allocated_bytes": peak, "profile": prof,
        "confirmed_frames_agreed": len(agreed), "path_stacks_bit_exact": stack_shapes,
    }
    fail = []
    if cuda and launches != loop["resims"]:
        fail.append(f"{launches} fold launches for {loop['resims']} resims")
    if any(result["desyncs"]) or len(agreed) < frames // 2 or loop["rollbacks"] == 0:
        fail.append("desync, few agreed frames or no rollback")
    if mode == "pipelined":
        if loop["forced"] or loop["staging_deferred_blocks"]:
            fail.append("the pipelined loop waited for the card")
        if loop["host_uploads"] != loop["resims"] or loop["donated_dispatches"] == 0:
            fail.append("not one packed upload per resim, or no donation")
    elif loop["host_uploads"] != 2 * loop["resims"]:
        fail.append("the sync path did not make two uploads per resim")
    if cuda:
        # the runner's census above is exact; the trace must agree, but may
        # miss one tick's copy records at the window's edge (seen on the
        # H100: 59 of 60)
        uploads = 1 if mode == "pipelined" else 2
        want = uploads * prof["profiled_resims"]
        if prof["htod_pageable"] or prof["htod"] != prof["htod_pinned"] \
                or not want - uploads <= prof["htod_pinned"] <= want:
            fail.append(f"host-to-device copies per resim: {prof}")
    if fail:
        raise SystemExit(f"chip_smoke: pipeline {name}/{mode}: {'; '.join(fail)}: {result}")
    result["agreed"] = agreed
    return result


def phase_pipeline(dev, card: str) -> int:
    """P2P traffic (stress_soa 1M and fixed_point) and SyncTest (stress_soa
    100k, d=7) in the runner's default mode and in the sync baseline: the
    same confirmed checksums, fixed_point's equal to a CPU pair's, and the
    pipelined loops free of host waits.  Returns the pipelined P2P loops'
    fold launches."""
    from bevy_ggrs_tpu_torch.models import fixed_point, stress_soa

    n = SIZES["p2p_stress_entities"]
    pairs = {
        f"stress_soa_{n}": lambda: stress_soa.make_app(n_entities=n, device=dev),
        "fixed_point": lambda: fixed_point.make_app(device=dev),
    }
    launches = 0
    fps = {}
    for seed, (name, make_app) in enumerate(pairs.items()):
        runs = {mode: pipeline_run(name, make_app, dev, seed, mode) for mode in MODES}
        a, b = runs["pipelined"].pop("agreed"), runs["sync"].pop("agreed")
        shared = sorted(set(a) & set(b))
        if len(shared) < SIZES["pipeline_frames"] // 2 or any(a[f] != b[f] for f in shared):
            raise SystemExit(f"chip_smoke: pipeline {name}: the modes' confirmed "
                             f"checksums differ ({len(shared)} shared frames)")
        if name == "fixed_point":
            cpu = pipeline_run(name, lambda: fixed_point.make_app(device="cpu"),
                               torch.device("cpu"), seed, "pipelined").pop("agreed")
            on_cpu = [f for f in shared if f in cpu]
            if len(on_cpu) < SIZES["pipeline_frames"] // 2 \
                    or any(a[f] != cpu[f] for f in on_cpu):
                raise SystemExit("chip_smoke: pipeline fixed_point: the card's confirmed "
                                 "checksums differ from the CPU pair's")
            runs["pipelined"]["frames_equal_to_cpu_pair"] = len(on_cpu)
        launches += runs["pipelined"]["fold_launches"]
        for mode, r in runs.items():
            fps[f"{name}/{mode}"] = r["frames_per_s_per_peer"]
            emit("pipeline", card=card, modes_agree_at_frames=len(shared), **r)
    synctests = {}
    for mode, kw in MODES.items():
        app = stress_soa.make_app(n_entities=SIZES["synctest_stress_entities"], device=dev)
        synctests[mode] = synctest(app, SIZES["synctest_stress_frames"], **kw)
    streams = [r.pop("stream") for r in synctests.values()]
    if streams[0] != streams[1] or synctests["pipelined"]["donated_dispatches"] == 0:
        raise SystemExit("chip_smoke: pipeline SyncTest: the modes' checksum streams "
                         "differ, or the pipelined run donated nothing")
    for mode, r in synctests.items():
        fps[f"synctest_stress_soa_100k/{mode}"] = r["frames_per_s"]
        emit("pipeline_synctest", model="stress_soa_100k", mode=mode, card=card,
             streams_equal=True, **r)
    emit("pipeline_frames_per_s", card=card, frames_per_s_per_peer=fps)
    return launches


# -- speculation: the branch axis, the cache, the canonical-branched program ------


def trees_equal(a, b) -> bool:
    from bevy_ggrs_tpu_torch.utils.tree import tree_flatten

    return all(x.shape == y.shape and torch.equal(x, y)
               for x, y in zip(tree_flatten(a), tree_flatten(b), strict=True))


def check_fold_on(name: str, reg, stacked) -> list:
    """The fold on one (flattened) stack, bit for bit against its plain
    version; returns the ``[F, N]`` shape checked."""
    from bevy_ggrs_tpu_torch.ops import checksum_fold as cf

    args = fold_inputs(reg, stacked)
    got, want = cf.checksum_fold(*args), cf.checksum_fold_plain(*args)
    if not torch.equal(got, want):
        raise SystemExit(f"chip_smoke: {name}: checksum_fold disagrees with its plain "
                         "version on a branch stack")
    return list(args[2].shape)


def speculate_call(dev) -> dict:
    """One draft at full width through ``SpeculationCache.speculate``: each
    lane equal to ``App.resim_fn`` on its inputs, bit for bit; one fold
    launch, zero vmap fallbacks; kernels, host and device ms beside a
    plain k=8 resim's."""
    import bevy_ggrs_tpu_torch.ops.resim as tr
    from bevy_ggrs_tpu_torch import SpeculationCache, SpeculationConfig, pad_candidates
    from bevy_ggrs_tpu_torch.models import stress_soa
    from bevy_ggrs_tpu_torch.ops import checksum_fold as cf
    from bevy_ggrs_tpu_torch.ops.resim import select_branch

    n, m, depth = SIZES["bench_entities"], SIZES["spec_lanes"], SIZES["spec_depth"]
    cuda = dev.type == "cuda"
    app = stress_soa.make_app(n_entities=n, device=dev)
    world = app.init_state()
    candidates = pad_candidates(2, [0, 1], [0, 1])
    cache = SpeculationCache(app, SpeculationConfig(candidates_fn=candidates, depth=depth,
                                                    max_cached_frames=16))
    used = np.zeros(2, np.uint8)
    cache.speculate(world, 0, used)  # warm-up
    sync(dev)
    tr.vmap_fallbacks = 0
    cf.launches = 0
    t0 = time.perf_counter()
    cache.speculate(world, 1, used)
    host_ms = (time.perf_counter() - t0) * 1e3
    sync(dev)
    call_ms = (time.perf_counter() - t0) * 1e3
    launches, fallbacks = cf.launches, tr.vmap_fallbacks
    cands = candidates(used)
    inputs, status = branch_inputs(app, cands, depth)
    _, entry = cache._cache[1]
    for b in range(m):
        stacked_b, checks_b = entry[np.ascontiguousarray(cands[b]).tobytes()]
        _, want, want_checks = app.resim_fn(world, inputs[b], status[b], 1)
        if not trees_equal(stacked_b, want) or not torch.equal(checks_b, want_checks):
            raise SystemExit(f"chip_smoke: speculate lane {b} differs from App.resim_fn "
                             "on its inputs")
    finals, stacked, checks = app.speculate_fn(world, inputs, status, 1)
    for b in range(m):
        final, _, _ = app.resim_fn(world, inputs[b], status[b], 1)
        if not trees_equal(select_branch(finals, b), final):
            raise SystemExit(f"chip_smoke: speculate lane {b}'s final world differs")
    fold_shape = check_fold_on("speculate", app.reg, flat_branches(stacked)) if cuda else []
    result = {"entities": n, "lanes": m, "depth": depth, "fold_launches": launches,
              "vmap_fallbacks": fallbacks, "lanes_bit_exact": m,
              "fold_bit_exact_on": fold_shape, "first_timed_call_host_ms": host_ms,
              "first_timed_call_ms": call_ms, "host_uploads": cache.host_uploads,
              "draft_dispatches": cache.draft_dispatches}
    if cuda and launches != 1:
        raise SystemExit(f"chip_smoke: one speculate launched the fold {launches} times")
    if fallbacks:
        raise SystemExit(f"chip_smoke: {fallbacks} vmap fallbacks on the speculate path")
    if cache.host_uploads != cache.draft_dispatches:
        raise SystemExit("chip_smoke: not one packed upload per draft")
    if cuda:
        one = on_device(np.zeros((depth, 2), np.uint8), dev)
        plain = lambda: app.resim_fn(world, one, one.to(torch.int8), 1)  # noqa: E731
        spec = lambda: app.speculate_fn(world, inputs, status, 1)  # noqa: E731
        for name, fn in (("speculate", spec), ("plain_resim_k8", plain)):
            prof = device_profile(fn, 3)
            result[name] = {"ms": time_ms(fn, 5),
                            "device_events_per_call": prof["device_events_per_call"],
                            "device_ms_per_call": prof["device_ms_per_call"],
                            "host_ms_per_call": prof["host_ms_per_call"],
                            "profiler_saw_device": prof["profiler_saw_device"]}
    return result


def service_pair(dev, speculation=None) -> dict:
    """The JAX bench's speculation-service traffic on a port pair:
    stress_soa at ``svc_entities``, 6 hops, input delay 1, inputs flipping
    every 7 ticks, checksums compared every frame, service times measured;
    ``svc_warm`` ticks, then ``svc_ticks`` timed and counted."""
    from bevy_ggrs_tpu_torch import DesyncDetection, GgrsRunner, PlayerType, SessionBuilder
    from bevy_ggrs_tpu_torch.models import stress_soa
    from bevy_ggrs_tpu_torch.ops import checksum_fold as cf
    from bevy_ggrs_tpu_torch.session.channel import ChannelNetwork
    from bevy_ggrs_tpu_torch.utils import compile_guard

    cuda = dev.type == "cuda"
    if cuda:
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    net = ChannelNetwork(seed=7, latency_hops=SIZES["svc_latency_hops"])
    socks = [net.endpoint(f"s{i}") for i in range(2)]
    runners = []
    for i in range(2):
        app = stress_soa.make_app(n_entities=SIZES["svc_entities"], device=dev)
        session = (SessionBuilder.for_app(app).with_input_delay(1)
                   .with_desync_detection_mode(DesyncDetection.on(1))
                   .add_player(PlayerType.LOCAL, i)
                   .add_player(PlayerType.REMOTE, 1 - i, f"s{1 - i}")
                   .start_p2p_session(socks[i]))
        count = [0]

        def read_inputs(handles, count=count):
            count[0] += 1
            return {h: np.uint8((count[0] // SIZES["svc_flip_ticks"]) % 2) for h in handles}

        runners.append(GgrsRunner(app, session, read_inputs=read_inputs,
                                  speculation=speculation, measure_rollback_service=True))
    seen = [record_confirmed(r) for r in runners]
    sync_sessions(runners, net)
    kept = keep_stacks(runners)
    drive(runners, SIZES["svc_warm"], net)

    def census():
        caches = [r.spec_cache for r in runners if r.spec_cache is not None]
        return {"resims": sum(r.resims for r in runners),
                "drafts": sum(c.draft_dispatches for c in caches),
                "draft_uploads": sum(c.host_uploads for c in caches),
                "hits": sum(c.hits for c in caches),
                "misses": sum(c.misses for c in caches),
                "served": sum(r.cache_served_frames for r in runners),
                "rollbacks": sum(r.rollbacks for r in runners),
                "service": {p: sum((r.rollback_service_ms[p] for r in runners), [])
                            for p in ("hit", "miss")}}

    before = census()
    sync(dev)
    cf.launches = 0
    # the warm-up ran every program variant this traffic reaches: the
    # measured window runs with the compile guard armed (bench.py's
    # speculation-service arm), so a new variant raises RecompileError
    guard = compile_guard.set_compile_guard(True)
    runners[0].arm_compile_guard()
    try:
        t0 = time.perf_counter()
        drive(runners, SIZES["svc_ticks"], net)
        sync(dev)
        dt = time.perf_counter() - t0
    finally:
        guard.disarm()
        compile_guard.set_compile_guard(False)
    launches = cf.launches
    after = census()
    loop = {k: after[k] - before[k] for k in after if k != "service"}
    service = {}
    for path in ("hit", "miss"):
        ms = after["service"][path][len(before["service"][path]):]
        p50, p99 = np.percentile(ms, [50, 99]).tolist() if ms else (None, None)
        service[path] = {"n": len(ms), "p50_ms": p50, "p99_ms": p99}
    peak = torch.cuda.max_memory_allocated(dev) if cuda else None
    for r in runners:
        r.finish()
    agreed = agreed_checksums(seen)
    stack_shapes = check_stacks("speculation service", kept) if cuda else []
    lookups = loop["hits"] + loop["misses"]
    return {"hedged": speculation is not None, "entities": SIZES["svc_entities"],
            "ticks": SIZES["svc_ticks"], "seconds": dt,
            "frames_per_s_per_peer": sum(r.frame for r in runners) / 2 / dt,
            "loop": loop, "fold_launches": launches,
            "hit_rate": loop["hits"] / lookups if lookups else None,
            "rollback_service_ms": service, "cache_served_frames": loop["served"],
            "max_memory_allocated_bytes": peak,
            "steady_recompiles": len(guard.steady_compiles),
            "desyncs": [len(desyncs(r)) for r in runners],
            "confirmed_frames_agreed": len(agreed), "path_stacks_bit_exact": stack_shapes,
            "census": {k: after[k] for k in ("hits", "misses", "drafts")},
            "agreed": agreed}


def branched_pair(dev, hedge: bool) -> dict:
    """A canonical-branched box_game pair (``branched_pair_depth`` x
    ``branched_lanes``, the JAX soak's shape) on phase 8's traffic; with
    ``hedge`` peer 1 (which mispredicts peer 0's flips) hedges eight
    candidates in its lanes.  The timed loop runs under
    ``set_sync_debug_mode("error")``, with no forced readback, no staging
    wait and one upload per dispatch; the fold is held to its plain
    version on the pair's own ``[B * K]`` stacks."""
    from bevy_ggrs_tpu_torch import SpeculationConfig, pad_candidates
    from bevy_ggrs_tpu_torch.models import box_game
    from bevy_ggrs_tpu_torch.ops import checksum_fold as cf
    from bevy_ggrs_tpu_torch.session.channel import ChannelNetwork

    cuda = dev.type == "cuda"
    net = ChannelNetwork(latency_hops=SIZES["p2p_latency_hops"], loss=0.0, seed=6)
    socks = [net.endpoint("p0"), net.endpoint("p1")]
    spec = SpeculationConfig(candidates_fn=pad_candidates(2, [0], [0, 1, 2, 4, 8, 9, 10, 12]))
    depth = SIZES["branched_pair_depth"]
    runners = [p2p_peer(lambda: branched_app(lambda: box_game.make_app(device=dev), dev,
                                             depth=depth),
                        i, socks[i], f"p{1 - i}",
                        speculation=spec if hedge and i == 1 else None) for i in range(2)]
    seen = [record_confirmed(r) for r in runners]
    sync_sessions(runners, net)
    kept = keep_stacks(runners)
    drive(runners, SIZES["branched_warm"], net)
    frames = SIZES["branched_frames"]
    before = counters(runners)
    sync(dev)
    cf.launches = 0
    t0 = time.perf_counter()
    if cuda:
        torch.cuda.set_sync_debug_mode("error")
    try:
        drive(runners, frames, net)
    finally:
        if cuda:
            torch.cuda.set_sync_debug_mode("default")
    sync(dev)
    dt = time.perf_counter() - t0
    launches = cf.launches
    after = counters(runners)
    loop = {k: after[k] - before[k] for k in after}
    for r in runners:
        r.finish()
    agreed = agreed_checksums(seen)
    stack_shapes = check_stacks("branched pair", kept) if cuda else []
    st = runners[1].stats()
    result = {"hedged": hedge, "frames": frames, "seconds": dt,
              "sync_debug_mode": "error" if cuda else "default",
              "frames_per_s_per_peer": loop["frames"] / 2 / dt,
              "rollbacks": [r.rollbacks for r in runners], "resim_calls": loop["resims"],
              "fold_launches": launches, "loop": loop,
              "speculation_hits": st["speculation_hits"],
              "speculation_misses": st["speculation_misses"],
              "cache_served_frames": st["cache_served_frames"],
              "desyncs": [len(desyncs(r)) for r in runners],
              "confirmed_frames_agreed": len(agreed), "path_stacks_bit_exact": stack_shapes,
              "agreed": agreed}
    fail = []
    if cuda and launches != loop["resims"]:
        fail.append(f"{launches} fold launches for {loop['resims']} resims")
    if loop["forced"] or loop["staging_deferred_blocks"]:
        fail.append("the pipelined loop waited for the card")
    if loop["host_uploads"] != loop["resims"]:
        fail.append("not one upload per dispatch")
    if any(result["desyncs"]) or runners[1].rollbacks == 0 or len(agreed) < frames // 2 \
            or (hedge and st["speculation_hits"] == 0):
        fail.append("out of sync, no rollback or no hit")
    if fail:
        raise SystemExit(f"chip_smoke: branched pair: {'; '.join(fail)}: "
                         f"{ {k: v for k, v in result.items() if k != 'agreed'} }")
    return result


def branched_call(dev) -> dict:
    """One ``branched_fn`` call at stress_soa ``branched_call_entities`` x
    4 players, B=16, K=8: lane 0 (5 real frames) equal to the canonical
    resim, each hedge lane to the canonical resim of its inputs."""
    from bevy_ggrs_tpu_torch.models import stress_soa
    from bevy_ggrs_tpu_torch.ops import checksum_fold as cf
    from bevy_ggrs_tpu_torch.ops.resim import select_branch, slice_frame, trim_frames

    n, players = SIZES["branched_call_entities"], SIZES["branched_call_players"]
    lanes, depth = SIZES["branched_call_lanes"], SIZES["branched_depth"]

    def make():
        app = stress_soa.make_app(n_entities=n, canonical_depth=depth, device=dev)
        app.num_players = players
        return app

    app, plain = branched_app(make, dev, lanes, depth), make()
    world = app.init_state()
    rng = np.random.default_rng(16)
    ib = rng.integers(0, 16, (lanes, depth, players)).astype(np.uint8)
    sb = rng.integers(0, 2, (lanes, depth, players)).astype(np.int8)
    sb[1:, 4:] = 0
    k0 = 5
    n_real = [k0] + [depth] * (lanes - 1)
    args = (world, on_device(ib, dev), on_device(sb, dev), 3, n_real)
    sync(dev)
    cf.launches = 0
    finals, stacked, checks = app.branched_fn(*args)
    launches = cf.launches
    lane0 = plain.resim_fn(world, on_device(ib[0, :k0], dev), on_device(sb[0, :k0], dev), 3)
    got0 = select_branch((finals, *trim_frames((stacked, checks), k0, axis=1)), 0)
    if not trees_equal(got0, lane0):
        raise SystemExit("chip_smoke: branched lane 0 differs from the canonical resim")
    lane = select_branch(stacked, 0)
    last = slice_frame(lane, k0 - 1)
    if not all(trees_equal(slice_frame(lane, i), last) and torch.equal(checks[0, i], checks[0, k0 - 1])
               for i in range(k0, depth)):
        raise SystemExit("chip_smoke: branched lane 0 does not hold its state past n_real")
    for b in range(1, lanes):
        want = plain.resim_fn(world, on_device(ib[b], dev), on_device(sb[b], dev), 3)
        if not trees_equal(select_branch((finals, stacked, checks), b), want):
            raise SystemExit(f"chip_smoke: branched hedge lane {b} differs from the "
                             "canonical resim of its inputs")
    result = {"entities": n, "players": players, "lanes": lanes, "depth": depth,
              "lane0_real_frames": k0, "fold_launches": launches, "lanes_bit_exact": lanes}
    if dev.type == "cuda":
        if launches != 1:
            raise SystemExit(f"chip_smoke: a branched call launched the fold {launches} times")
        result["fold_bit_exact_on"] = check_fold_on("branched", app.reg, flat_branches(stacked))
        result["ms"] = time_ms(lambda: app.branched_fn(*args), 5)
        result["lane0_useful_frames_per_s"] = k0 / result["ms"] * 1e3
    return result


def disarmed_notify_ns(calls: int = 1_000_000) -> float:
    """Host ns per ``compile_guard.notify`` call with the guard disarmed
    (the cost every first dispatch pays when the guard is off); printed,
    not gated."""
    from bevy_ggrs_tpu_torch.utils import compile_guard

    compile_guard.set_compile_guard(False)
    notify = compile_guard.notify
    t0 = time.perf_counter()
    for _ in range(calls):
        notify("solo", "plain", 0.0)
    return (time.perf_counter() - t0) * 1e9 / calls


def phase_speculation(dev, card: str) -> dict:
    """The branch axis and the cache (see the module docstring); returns
    the fold launches of the hedged service loop and of the hedged
    canonical-branched pair."""
    emit("speculation_call", card=card, **speculate_call(dev))
    plain = service_pair(dev)
    from bevy_ggrs_tpu_torch import SpeculationConfig, pad_candidates

    hedged = service_pair(dev, SpeculationConfig(
        candidates_fn=pad_candidates(2, [0, 1], [0, 1]), depth=SIZES["spec_depth"],
        max_cached_frames=16))
    a, b = hedged.pop("agreed"), plain.pop("agreed")
    shared = sorted(set(a) & set(b))
    fail = []
    if len(shared) < SIZES["svc_ticks"] // 2 or any(a[f] != b[f] for f in shared):
        fail.append(f"hedged and plain pairs' confirmed checksums differ ({len(shared)} shared)")
    for r in (plain, hedged):
        if any(r["desyncs"]) or r["loop"]["rollbacks"] == 0:
            fail.append(f"desync or no rollback (hedged={r['hedged']})")
    loop = hedged["loop"]
    if loop["hits"] == 0 or not hedged["hit_rate"] > 0.5:
        fail.append(f"hits {loop['hits']}, hit rate {hedged['hit_rate']}")
    if loop["draft_uploads"] != loop["drafts"]:
        fail.append("not one packed upload per draft")
    if dev.type == "cuda":
        if hedged["fold_launches"] != loop["resims"] + loop["drafts"]:
            fail.append(f"{hedged['fold_launches']} fold launches for {loop['resims']} "
                        f"resims and {loop['drafts']} drafts")
        if plain["fold_launches"] != plain["loop"]["resims"]:
            fail.append("the plain pair: not one fold launch per resim")
    if fail:
        raise SystemExit(f"chip_smoke: speculation service: {'; '.join(fail)}: "
                         f"{[hedged, plain]}")
    guard_ns = disarmed_notify_ns()
    for r in (plain, hedged):
        emit("speculation_service", card=card, pairs_agree_at_frames=len(shared),
             disarmed_notify_ns=guard_ns, **r)
    pairs = {hedge: branched_pair(dev, hedge) for hedge in (False, True)}
    a, b = pairs[True].pop("agreed"), pairs[False].pop("agreed")
    shared = sorted(set(a) & set(b))
    if len(shared) < SIZES["branched_frames"] // 2 or any(a[f] != b[f] for f in shared):
        raise SystemExit("chip_smoke: the hedged canonical-branched pair's confirmed "
                         "checksums differ from the plain canonical pair's")
    for r in pairs.values():
        emit("speculation_branched_pair", card=card, pairs_agree_at_frames=len(shared), **r)
    emit("speculation_branched_call", card=card, **branched_call(dev))
    return {"speculation": hedged["fold_launches"],
            "branched": pairs[True]["fold_launches"]}


# -- many worlds: waves, the BatchedRunner, idle-lane drafts ----------------------


def wave_buffer(app, starts, k: int, seed: int):
    """A packed wave ``int8[M, k + 1, W]``: lane ``b`` starts at
    ``starts[b]`` and advances ``k`` frames on seeded inputs; returns the
    host buffer and the inputs and statuses on the app's device."""
    from bevy_ggrs_tpu_torch.ops.packing import pack_prefix, pack_row

    spec = app.packed_spec
    m = len(starts)
    rng = np.random.default_rng(seed)
    inputs = rng.integers(0, 16, (m, k, app.num_players)).astype(app.input_dtype)
    status = np.zeros((m, k, app.num_players), np.int8)
    buf = spec.new_batch_buffer(m, k)
    for b in range(m):
        pack_prefix(buf[b], starts[b], k)
        for i in range(k):
            pack_row(spec, buf[b], i, inputs[b, i], status[b, i])
    return buf, on_device(inputs, app.device), on_device(status, app.device)


def wave_throughput(dev, lobbies: int, entities: int, card: str) -> dict:
    """Part (a): ``lobbies`` stress_soa worlds x k=8 through the executor's
    exact full-wave program, at spread per-lane start frames (the last lane
    straddles I32_MAX), lane ``b`` from the init world advanced ``b % 4``
    frames: every lane bit-equal to a solo resim of its own world, one fold
    launch per wave, the fold bit-exact on the wave's ``[M·k, N]`` stack;
    lobby-frames/s (median and spread of 5 reps x 30 chained waves),
    device events per wave and the device's busy and idle shares."""
    from bevy_ggrs_tpu_torch import BucketedWaveExecutor, stack_worlds, unstack_world
    from bevy_ggrs_tpu_torch.models import stress_soa
    from bevy_ggrs_tpu_torch.ops import checksum_fold as cf
    from bevy_ggrs_tpu_torch.ops import resim as R
    from bevy_ggrs_tpu_torch.utils.mem import tree_device_bytes

    k = SIZES["bench_k"]
    app = stress_soa.make_app(n_entities=entities, device=dev)
    ex = BucketedWaveExecutor(app, k)
    starts = [-(2**31) + 12_345 + b * (2**32 // lobbies) for b in range(lobbies - 1)]
    starts.append(2**31 - 3)
    buf, inputs, status = wave_buffer(app, starts, k, seed=lobbies)
    bases = [app.init_state()]
    for j in range(3):
        bases.append(app.resim_fn(bases[-1], inputs[0, :1], status[0, :1], j)[0])
    lane_worlds = [bases[b % len(bases)] for b in range(lobbies)]
    worlds = stack_worlds(lane_worlds)
    ks = [k] * lobbies
    sync(dev)
    cf.launches = 0
    R.vmap_fallbacks = 0
    bucket, finals, stacked, checks = ex.run_wave_packed(worlds, buf, ks)
    sync(dev)
    launches = cf.launches
    if launches != (dev.type == "cuda") or bucket != k or R.vmap_fallbacks:
        raise SystemExit(f"chip_smoke: batched wave: {launches} fold launches, bucket "
                         f"{bucket}, {R.vmap_fallbacks} vmap fallbacks")
    for b in range(lobbies):
        final, solo_stacked, solo_checks = app.resim_fn(lane_worlds[b], inputs[b], status[b],
                                                        starts[b])
        if not (trees_equal(unstack_world(finals, b), final)
                and trees_equal(unstack_world(stacked, b), solo_stacked)
                and torch.equal(checks[b * k:(b + 1) * k], solo_checks)):
            raise SystemExit(f"chip_smoke: batched wave: lane {b} differs from its solo resim")
    fold_shape = check_fold_on("batched wave", app.reg, flat_branches(stacked))
    del finals, stacked, checks, bases, lane_worlds
    rates = []
    w = worlds
    for _ in range(SIZES["wave_reps"]):
        sync(dev)
        t0 = time.perf_counter()
        for _ in range(SIZES["wave_iters"]):
            _, w, _, _ = ex.run_wave_packed(w, buf, ks)
        sync(dev)
        rates.append(SIZES["wave_iters"] * lobbies * k / (time.perf_counter() - t0))
    wall_ms = lobbies * k / statistics.median(rates) * 1e3
    prof = device_profile(lambda: ex.run_wave_packed(w, buf, ks), SIZES["profile_calls"] // 4)
    busy = prof["device_ms_per_call"] / wall_ms
    out = {"lobbies": lobbies, "entities": entities, "k": k, "card": card,
           "lanes_bit_equal_to_solo": lobbies, "fold_launches_per_wave": launches,
           "fold_exact_on": fold_shape, "vmap_fallbacks": R.vmap_fallbacks,
           "lobby_frames_per_s_median": statistics.median(rates),
           "lobby_frames_per_s_min": min(rates), "lobby_frames_per_s_max": max(rates),
           "wall_ms_per_wave": wall_ms,
           "device_events_per_wave": prof["device_events_per_call"],
           "htod_copies_per_wave": prof["htod_copies_per_call"],
           "device_ms_per_wave": prof["device_ms_per_call"],
           "host_ms_per_wave_profiled": prof["host_ms_per_call"],
           "device_busy_share": busy, "device_idle_share": 1 - busy,
           "world_bytes": tree_device_bytes(worlds),
           "stack_bytes": tree_device_bytes(worlds) * k,
           "peak_memory_bytes": torch.cuda.max_memory_allocated(dev)}
    if not prof["profiler_saw_device"] or not 0 < busy <= 1.5:
        raise SystemExit(f"chip_smoke: batched wave profile: {out}")
    return out


def clock_app(dev):
    """A step that writes its clock into every entity (the frame, the
    retire horizon, the time) and folds its inputs and the frame into a
    running value: a lane on another lane's clock, inputs or world shows
    in its state and its checksum."""
    from bevy_ggrs_tpu_torch import App
    from bevy_ggrs_tpu_torch.snapshot import spawn

    app = App(num_players=2, capacity=4, input_shape=(), input_dtype=np.uint8, retention=5,
              fps=60, device=dev)
    for name, dt in (("f", torch.int32), ("r", torch.int32), ("t", torch.float32),
                     ("acc", torch.int32)):
        app.rollback_component(name, (), dt)

    def step(world, ctx):
        c = world.comps
        one = torch.ones_like(c["f"])
        mix = ctx.inputs.to(torch.int32).sum() * 7 + ctx.frame
        return dataclasses.replace(world, comps={
            "f": one * ctx.frame, "r": one * ctx.retire_frame,
            "t": torch.ones_like(c["t"]) * ctx.time_seconds,
            "acc": (c["acc"] * 31 + mix) & 0xFFFF})

    def setup(world):
        for _ in range(2):
            world, _ = spawn(app.reg, world, {"f": 0, "r": 0, "t": 0.0, "acc": 0})
        return world

    app.set_step(step)
    app.set_setup(setup)
    return app


def wave_lanes(dev) -> dict:
    """Part (a)'s lane check where a fault would show: the clock app and
    fixed_point (both read their inputs and their frame), lane ``b`` from
    the init world advanced ``b`` frames on its own inputs, starts that
    straddle I32_MAX, a full wave (the exact program) and a ragged one
    (the ``n_real``-masked program, one lane idle): every lane bit-equal
    to the solo resim of its own frames, one fold launch per wave."""
    from bevy_ggrs_tpu_torch import BucketedWaveExecutor, stack_worlds, unstack_world
    from bevy_ggrs_tpu_torch.models import fixed_point
    from bevy_ggrs_tpu_torch.ops import checksum_fold as cf
    from bevy_ggrs_tpu_torch.ops.packing import pack_prefix
    from bevy_ggrs_tpu_torch.utils.tree import tree_map

    k = SIZES["bench_k"]
    starts = [2**31 - 1 - b for b in range(4)] + [-(2**31) + b for b in range(4)]
    m = len(starts)
    waves = {"full": [k] * m, "ragged": [k, k - 1, 1, 0, k, 3, k - 2, 5]}
    out = {}
    for name, app in (("clock", clock_app(dev)), ("fixed_point", fixed_point.make_app(device=dev))):
        buf, inputs, status = wave_buffer(app, starts, k, seed=m)
        worlds = [app.init_state()]
        for b in range(1, m):
            worlds.append(app.resim_fn(worlds[0], inputs[b, :b], status[b, :b], 1000 * b)[0])
        ex = BucketedWaveExecutor(app, k)
        for wave, ks in waves.items():
            for b in range(m):
                pack_prefix(buf[b], starts[b], ks[b])
            cf.launches = 0
            bucket, finals, stacked, checks = ex.run_wave_packed(stack_worlds(worlds), buf, ks)
            sync(dev)
            if cf.launches != (dev.type == "cuda") or bucket != k:
                raise SystemExit(f"chip_smoke: wave lanes {name} {wave}: {cf.launches} fold "
                                 f"launches, bucket {bucket}")
            for b, n in enumerate(ks):
                if n == 0:
                    ok = trees_equal(unstack_world(finals, b), worlds[b])
                else:
                    final, solo, solo_checks = app.resim_fn(worlds[b], inputs[b, :n],
                                                            status[b, :n], starts[b])
                    ok = (trees_equal(unstack_world(finals, b), final)
                          and trees_equal(tree_map(lambda a: a[:n], unstack_world(stacked, b)),
                                          solo)
                          and torch.equal(checks[b * k:b * k + n], solo_checks))
                if not ok:
                    raise SystemExit(f"chip_smoke: wave lanes {name} {wave}: lane {b} "
                                     f"(start {starts[b]}, {n} frames) differs from its "
                                     "solo resim")
        out[name] = {wave: m for wave in waves}
    return {"starts": starts, "ragged_ks": waves["ragged"], "lanes_bit_equal_to_solo": out}


def flatness_run(dev, lobbies: int) -> dict:
    """Part (b): a BatchedRunner over ``lobbies`` SyncTest lobbies of
    ``stress.make_app(64, capacity=64)`` at check distance 2; the launches
    and copies of the 8 ticks after 4 of warm-up, from the profiler."""
    from torch.profiler import ProfilerActivity, profile

    from bevy_ggrs_tpu_torch import BatchedRunner, SyncTestSession
    from bevy_ggrs_tpu_torch.models import stress

    app = stress.make_app(64, capacity=64, device=dev)
    br = BatchedRunner(app, [SyncTestSession(2, check_distance=2) for _ in range(lobbies)],
                       read_inputs=lambda b, hs: {h: np.uint8((b + h) & 0xF) for h in hs})
    for _ in range(SIZES["flat_warm"]):
        br.tick()
    sync(dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(SIZES["flat_ticks"]):
            br.tick()
        sync(dev)
    br.finish()
    counts = {"kernels": 0, "copies": 0, "fills": 0}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA \
                or getattr(e, "is_user_annotation", False) or e.key.startswith("ProfilerStep"):
            continue
        kind = "copies" if "Memcpy" in e.key else "fills" if "Memset" in e.key else "kernels"
        counts[kind] += e.count
    st = br.stats()
    return {"lobbies": lobbies, **{f"{k}_per_tick": v / SIZES["flat_ticks"]
                                   for k, v in counts.items()},
            "device_dispatches": st["device_dispatches"], "bucket_hist": st["bucket_hist"],
            "fallback_loads": st["fallback_loads"]}


def pair_inputs(frame: int, lobby: int) -> np.uint8:
    """Peer 0 of pair ``lobby // 2`` flips its input every
    ``p2p_flip_frames`` frames, offset per pair; peer 1 holds it."""
    if lobby % 2:
        return np.uint8(8)
    return np.uint8(8 if ((frame + 3 * (lobby // 2)) // SIZES["p2p_flip_frames"]) % 2 == 0
                    else 1)


def pair_sessions(make_app, dev, pairs: int, seed: int):
    """``pairs`` P2P games of port sessions over ChannelNetworks (3 hops,
    input delay 1, window 8, checksums compared every frame)."""
    from bevy_ggrs_tpu_torch import DesyncDetection, PlayerType, SessionBuilder
    from bevy_ggrs_tpu_torch.session.channel import ChannelNetwork

    nets = [ChannelNetwork(latency_hops=SIZES["p2p_latency_hops"], seed=seed + g)
            for g in range(pairs)]
    sessions = []
    for g in range(pairs):
        for i in range(2):
            b = (SessionBuilder.for_app(make_app()).with_input_delay(1)
                 .with_max_prediction_window(8)
                 .with_desync_detection_mode(DesyncDetection.on(1))
                 .add_player(PlayerType.LOCAL, i)
                 .add_player(PlayerType.REMOTE, 1 - i, f"g{g}p{1 - i}"))
            sessions.append(b.start_p2p_session(nets[g].endpoint(f"g{g}p{i}")))
    return nets, sessions


def sync_all(nets, tick, sessions) -> None:
    for _ in range(2000):
        for net in nets:
            net.deliver()
        tick()
        if all(s.current_state().value == "running" for s in sessions):
            return
        time.sleep(0.0005)
    raise SystemExit("chip_smoke: batched P2P sessions never synchronized")


def note_confirmed(rings, confirmed, seen) -> None:
    """Each lobby's checksum refs at the frames it has confirmed (read
    later, off the clock)."""
    from bevy_ggrs_tpu_torch.utils.frames import frame_le

    for b, ring in enumerate(rings):
        for f in ring.frames():
            if frame_le(f, confirmed[b]):
                seen[b].setdefault(f, ring.peek(f)[1])


def waiting_sessions(make_app, n: int) -> list:
    """``n`` P2P sessions whose peers never answer: lobbies waiting for
    their players, whose lanes every wave leaves idle."""
    from bevy_ggrs_tpu_torch import PlayerType, SessionBuilder
    from bevy_ggrs_tpu_torch.session.channel import ChannelNetwork

    net = ChannelNetwork(latency_hops=1)
    return [SessionBuilder.for_app(make_app()).add_player(PlayerType.LOCAL, 0)
            .add_player(PlayerType.REMOTE, 1, f"absent{w}")
            .start_p2p_session(net.endpoint(f"waiting{w}")) for w in range(n)]


def flip_each_pad(used):
    """Speculation candidates: one row per pad with that pad's input
    flipped between the traffic's two values (8 and 1), the other as used;
    the row of a lobby's remote pad is its correction."""
    used = np.asarray(used)
    out = np.repeat(used[None], len(used), axis=0)
    for h in range(len(used)):
        out[h, h] = 9 - used[h]
    return out


def server_run(name: str, make_app, dev, card: str, speculation=None, waiting: int = 0) -> dict:
    """Parts (c) and (d): ``server_pairs`` P2P pairs (and ``waiting``
    lobbies that never start) as one BatchedRunner; the timed loop under
    sync debug mode "error"; the pairs' confirmed checksum refs; the peak
    device memory of the run.  Fails on a desync, a fold launch that is
    not a wave, a fallback load row, more than one upload per wave, a
    forced readback or a staging wait, and with drafts on, on branch
    caches that keep more bytes allocated than their entries' own."""
    from bevy_ggrs_tpu_torch import BatchedRunner
    from bevy_ggrs_tpu_torch.ops import checksum_fold as cf
    from bevy_ggrs_tpu_torch.utils.mem import tree_device_bytes

    pairs, frames = SIZES["server_pairs"], SIZES["server_frames"]
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    base_bytes = torch.cuda.memory_allocated(dev) if dev.type == "cuda" else 0
    nets, playing = pair_sessions(lambda: make_app(dev), dev, pairs, seed=40)
    sessions = playing + waiting_sessions(lambda: make_app(dev), waiting)
    br = BatchedRunner(make_app(dev), sessions, speculation=speculation,
                       read_inputs=lambda b, hs: {h: pair_inputs(br.frames[b], b) for h in hs})
    sync_all(nets, br.tick, playing)
    seen = [{} for _ in sessions]
    st0 = br.stats()
    sync(dev)
    cf.launches = 0
    t0 = time.perf_counter()
    debug = dev.type == "cuda"
    if debug:
        torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(frames):
            for net in nets:
                net.deliver()
            br.tick()
            note_confirmed(br.rings, br.confirmed, seen)
    finally:
        if debug:
            torch.cuda.set_sync_debug_mode(0)
    sync(dev)
    dt = time.perf_counter() - t0
    launches = cf.launches
    st = br.stats()
    waves = st["wave_dispatches"] - st0["wave_dispatches"]
    uploads = st["host_uploads"] - st0["host_uploads"]
    desyncs = [e for _b, e in br.events if type(e).__name__ == "DesyncDetected"]
    out = {"model": name, "card": card, "lobbies": len(playing), "waiting_lobbies": waiting,
           "ticks": frames,
           "seconds": dt, "lobby_frames": sum(st["frames"]) - sum(st0["frames"]),
           "rollbacks": st["rollbacks"] - st0["rollbacks"], "waves": waves,
           "waves_per_tick": waves / frames, "bucket_hist": st["bucket_hist"],
           "fused_loads": st["fused_loads"] - st0["fused_loads"],
           "fallback_loads": st["fallback_loads"], "fold_launches": launches,
           "uploads": uploads, "load_index_uploads": st["load_index_uploads"],
           "forced_readbacks": st["readbacks"]["forced"] - st0["readbacks"]["forced"],
           "staging_waits": st["staging_deferred_blocks"] - st0["staging_deferred_blocks"],
           "desyncs": len(desyncs), "stalled_frames": sum(st["stalled_frames"])}
    out["aggregate_frames_per_s"] = out["lobby_frames"] / dt
    out["per_lobby_frames_per_s"] = out["aggregate_frames_per_s"] / len(playing)
    if dev.type == "cuda":
        out["base_memory_bytes"] = base_bytes
        out["peak_memory_bytes"] = torch.cuda.max_memory_allocated(dev)
    fail = []
    if speculation is not None:
        out["speculation"] = st["speculation"]
        # what the entries' own tensors take: each lobby's drafted lanes
        out["speculation"]["entry_bytes"] = sum(tree_device_bytes(c._cache)
                                                for c in br.spec_caches)
        if out["speculation"]["cached_bytes"] > out["speculation"]["entry_bytes"]:
            fail.append("branch caches pin more than their entries")
    if desyncs or out["rollbacks"] == 0:
        fail.append("a desync or no rollback")
    if dev.type == "cuda" and launches != waves:
        fail.append(f"{launches} fold launches for {waves} waves")
    if out["fallback_loads"] or uploads != waves:
        fail.append("a fallback load row, or not one upload per wave")
    if out["forced_readbacks"] or out["staging_waits"]:
        fail.append("a forced readback or a staging wait")
    if fail:
        raise SystemExit(f"chip_smoke: batched server {name}: {'; '.join(fail)}: {out}")
    out["confirmed"] = seen[:len(playing)]
    return out


def solo_pairs(make_app, dev) -> list:
    """The same pairs as :func:`server_run` on solo port runners: each
    lobby's confirmed checksum refs."""
    from bevy_ggrs_tpu_torch import GgrsRunner

    nets, sessions = pair_sessions(lambda: make_app(dev), dev, SIZES["server_pairs"], seed=40)
    runners = []
    for b, s in enumerate(sessions):
        holder = []
        runners.append(GgrsRunner(make_app(dev), s, read_inputs=lambda hs, b=b, holder=holder: {
            h: pair_inputs(holder[0].frame, b) for h in hs}))
        holder.append(runners[-1])
    sync_all(nets, lambda: [r.update(0.0) for r in runners], sessions)
    seen = [record_confirmed(r) for r in runners]
    for _ in range(SIZES["server_frames"]):
        for net in nets:
            net.deliver()
        for r in runners:
            r.update(1.0 / 60.0)
    return seen


def same_confirmed(name: str, a: list, b: list) -> int:
    """Frames where both record a lobby's confirmed checksum: all equal
    (fails otherwise, or with too few shared frames)."""
    shared = 0
    for lobby, (x, y) in enumerate(zip(a, b)):
        frames = set(x) & set(y)
        if len(frames) < SIZES["server_frames"] // 2:
            raise SystemExit(f"chip_smoke: {name}: lobby {lobby} shares {len(frames)} frames")
        for f in frames:
            if x[f]() != y[f]():
                raise SystemExit(f"chip_smoke: {name}: lobby {lobby} differs at frame {f}")
        shared += len(frames)
    return shared


def phase_batched(dev, card: str) -> int:
    """The many-worlds slice (see the module docstring); returns the fold
    launches of the driven paths: the waves, the server loops."""
    from bevy_ggrs_tpu_torch import SpeculationConfig
    from bevy_ggrs_tpu_torch.models import fixed_point, stress_soa

    emit("batched_wave_lanes", card=card, **wave_lanes(dev))
    launches = 0
    for lobbies, entities in SIZES["wave_cells"]:
        r = wave_throughput(dev, lobbies, entities, card)
        launches += r["fold_launches_per_wave"]
        emit("batched_wave", **r)
        gc.collect()
        torch.cuda.empty_cache()
    flat = {m: flatness_run(dev, m) for m in (4, 16)}
    a, b = flat[4], flat[16]
    if (a["kernels_per_tick"], a["copies_per_tick"], a["fills_per_tick"]) != \
            (b["kernels_per_tick"], b["copies_per_tick"], b["fills_per_tick"]):
        raise SystemExit(f"chip_smoke: launches per tick differ between M=4 and M=16: {flat}")
    emit("batched_flatness", card=card, m4=a, m16=b)
    soa = lambda d: stress_soa.make_app(n_entities=SIZES["server_entities"], device=d)  # noqa: E731
    fxp = lambda d: fixed_point.make_app(device=d)  # noqa: E731
    runs = {}
    for name, make in (("stress_soa", soa), ("fixed_point", fxp)):
        r = server_run(name, make, dev, card)
        launches += r["fold_launches"]
        r["shared_with_solo"] = same_confirmed(f"batched {name} vs solo pairs",
                                               r["confirmed"], solo_pairs(make, dev))
        runs[name] = r
    # (c)'s traffic leaves no lane idle outside its rollback ticks, and a
    # draft there hedges only the lobbies that just rolled back; lobbies
    # waiting for players give every wave idle lanes to draft into.
    # fixed_point reads its inputs: a hit served from another candidate's
    # lane would change its confirmed checksums
    hedged = []
    for name, make in (("stress_soa", soa), ("fixed_point", fxp)):
        r = server_run(name, make, dev, card, waiting=2 * SIZES["server_pairs"],
                       speculation=SpeculationConfig(
                           candidates_fn=flip_each_pad, depth=SIZES["server_spec_depth"],
                           max_cached_frames=SIZES["server_spec_depth"]))
        launches += r["fold_launches"]
        if r["speculation"]["hits"] == 0:
            raise SystemExit(f"chip_smoke: batched drafts {name}: no hit: {r['speculation']}")
        r["shared_with_plain"] = same_confirmed(f"batched drafts {name} vs plain",
                                                r["confirmed"], runs[name]["confirmed"])
        hedged.append(r)
    for r in (*runs.values(), *hedged):
        r.pop("confirmed")
        emit("batched_server", hedged="speculation" in r, **r)
    return launches


# -- the megastep and the rest of the game surface --------------------------------


def session_frame_inputs(i: int, holder: list):
    """``frame_inputs`` keyed by the session's frame, not the runner's: a
    coalescing runner reads several ticks' inputs before its frame moves,
    so this keeps the game the same whatever the dispatch mode."""
    flip = SIZES["p2p_flip_frames"]

    def read_inputs(handles):
        on = i == 1 or (holder[0].session.current_frame // flip) % 2 == 0
        return {h: np.uint8(8 if on else 1) for h in handles}

    return read_inputs


def megastep_pair(name: str, make_app, dev, seed: int, megastep: bool) -> dict:
    """A P2P pair at ``coalesce_frames=4``, each update owing 4 frames,
    megastep on or off: the counters of a loop of ``megastep_frames``
    frames (under ``set_sync_debug_mode("error")`` with the megastep on the
    card), a profiled window, the confirmed checksums."""
    from bevy_ggrs_tpu_torch.ops import checksum_fold as cf

    cuda = dev.type == "cuda"
    co = SIZES["megastep_coalesce"]
    if cuda:
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    net, runners, seen = channel_pair(make_app, seed, inputs=session_frame_inputs,
                                      coalesce_frames=co, megastep=megastep)
    sync_sessions(runners, net)
    kept = keep_stacks(runners) if cuda else None
    drive(runners, SIZES["megastep_warm_rounds"], net, co)
    stack_shapes = []
    if cuda:
        # the fold against its plain version on the stacks the warm-up's
        # dispatches made (the megastep's [k_max, N]), checked and freed
        # here: kept through the loop they would raise its peak memory
        stack_shapes = check_stacks(f"megastep {name}", kept)
        if megastep and not any(key[0] == "megastep" for key in kept):
            raise SystemExit(f"chip_smoke: megastep {name}: no megastep stack kept")
        kept.open = False
        kept.clear()
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
    rounds = SIZES["megastep_frames"] // co
    before = counters(runners)
    sync(dev)
    cf.launches = 0
    debug = cuda and megastep
    t0 = time.perf_counter()
    if debug:
        torch.cuda.set_sync_debug_mode("error")
    try:
        drive(runners, rounds, net, co)
    finally:
        if debug:
            torch.cuda.set_sync_debug_mode("default")
    sync(dev)
    dt = time.perf_counter() - t0
    launches = cf.launches
    after = counters(runners)
    loop = {k: after[k] - before[k] for k in after}
    prof = profile_ticks(runners, net, SIZES["megastep_profile_rounds"], co) if cuda else {}
    peak = torch.cuda.max_memory_allocated(dev) if cuda else None
    for r in runners:
        r.finish()
    agreed = agreed_checksums(seen)
    flushes = 2 * rounds
    result = {
        "pair": name, "megastep": megastep, "device": str(dev), "frames": rounds * co,
        "coalesce_frames": co, "k_max": runners[0]._ms_k if megastep else None,
        "sync_debug_mode": "error" if debug else "default", "seconds": dt,
        "frames_per_s_per_peer": loop["frames"] / 2 / dt, "ms_per_flush": dt * 1e3 / flushes,
        "dispatches_per_flush": loop["resims"] / flushes, "loop": loop,
        "fold_launches": launches, "desyncs": [len(desyncs(r)) for r in runners],
        "launches_per_flush": (prof["launches"] / prof["profiled_peer_ticks"]
                               if prof else None),
        "launches_per_dispatch": (prof["launches"] / prof["profiled_resims"]
                                  if prof and prof["profiled_resims"] else None),
        "max_memory_allocated_bytes": peak, "peak_window": "after the warm-up",
        "profile": prof, "confirmed_frames_agreed": len(agreed),
        "warm_up_stacks_bit_exact": stack_shapes,
    }
    fail = []
    # a flush confirms several frames and the runner reports the last, so
    # about one confirmed frame per flush is recorded
    if any(result["desyncs"]) or len(agreed) < rounds // 2 or loop["rollbacks"] == 0:
        fail.append("desync, few agreed frames or no rollback")
    if cuda and launches != loop["resims"]:
        fail.append(f"{launches} fold launches for {loop['resims']} dispatches")
    if megastep:
        if loop["fused_ring_loads"] == 0 or loop["megastep_dispatches"] != loop["resims"]:
            fail.append("no fused ring load, or a dispatch outside the megastep")
        if loop["host_uploads"] != loop["megastep_dispatches"]:
            fail.append("not one upload per megastep dispatch")
        if loop["forced"] or loop["staging_deferred_blocks"]:
            fail.append("the megastep loop waited for the card")
    if fail:
        raise SystemExit(f"chip_smoke: megastep {name}: {'; '.join(fail)}: {result}")
    result["agreed"] = agreed
    return result


def megastep_capture(dev) -> dict:
    """One megastep call at stress_soa 1M captured in a CUDA graph and
    replayed with two other prefixes, one with a fused load and one
    without: final world, ring, ring tags, stacked states and checksums
    bit-equal to an eager call on the same ring."""
    from bevy_ggrs_tpu_torch.models import stress_soa
    from bevy_ggrs_tpu_torch.ops import checksum_fold as cf
    from bevy_ggrs_tpu_torch.ops.megastep import init_device_ring, make_megastep_fn
    from bevy_ggrs_tpu_torch.ops.packing import pack_prefix, pack_row, repeat_last_row
    from bevy_ggrs_tpu_torch.utils.tree import tree_flatten

    app = stress_soa.make_app(n_entities=SIZES["bench_entities"], device=dev)
    k_max = SIZES["megastep_coalesce"] + 8  # the P2P pair's: coalesce + window
    slots = 8 + 1 + SIZES["megastep_coalesce"] + 1
    fn = make_megastep_fn(app.reg, app.step, app.packed_spec, app.fps, seed=app.seed,
                          retention=app.retention, k_max=k_max, ring_slots=slots)
    spec = app.packed_spec
    host = torch.empty((k_max + 1, spec.width), dtype=torch.int8).pin_memory()

    def stage(start, n_real, has_load=0, load_slot=0):
        buf = host.numpy()
        pack_prefix(buf, start, n_real, has_load, load_slot)
        for i in range(n_real):
            pack_row(spec, buf, i, np.array([(start + i) % 16, 3], np.uint8),
                     np.zeros(2, np.int8))
        repeat_last_row(buf, n_real, k_max)
        rows.copy_(host, non_blocking=True)

    world = app.init_state()
    ring, tags = init_device_ring(world, slots)
    rows = torch.empty((k_max + 1, spec.width), dtype=torch.int8, device=dev)
    stage(0, k_max)  # fill the ring eagerly
    world, ring, tags, _, _ = fn(world, ring, tags, rows)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        warm_ring = [t.clone() for t in tree_flatten(ring)]
        fn(world, ring, tags, rows)
        for t, w in zip(tree_flatten(ring), warm_ring):
            t.copy_(w)
    torch.cuda.current_stream().wait_stream(side)
    sync(dev)
    stage(k_max, k_max)
    graph = torch.cuda.CUDAGraph()
    cf.launches = 0
    with torch.cuda.graph(graph):
        captured = fn(world, ring, tags, rows)
    capture_launches = cf.launches
    cases = {"fused_load": (5, 7, 1, 5 % slots), "no_load": (k_max + 3, k_max - 2, 0, 0)}
    checked = {}
    for name, prefix in cases.items():
        ring0 = [t.clone() for t in tree_flatten(ring)]
        tags0 = tags.clone()
        stage(*prefix)
        graph.replay()
        got = [t.clone() for t in tree_flatten((captured[0], captured[3]))] + [
            captured[4].clone(), *[t.clone() for t in tree_flatten(ring)], tags.clone()]
        for t, w in zip(tree_flatten(ring), ring0):
            t.copy_(w)
        tags.copy_(tags0)
        out = fn(world, ring, tags, rows)
        want = tree_flatten((out[0], out[3])) + [out[4], *tree_flatten(ring), tags]
        sync(dev)
        if len(got) != len(want) or not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise SystemExit(f"chip_smoke: megastep capture: the replay ({name}) "
                             "differs from the eager call")
        checked[name] = {"start_frame": prefix[0], "n_real": prefix[1],
                         "has_load": prefix[2], "load_slot": prefix[3],
                         "tensors_bit_equal": len(got)}
    if capture_launches != 1:
        raise SystemExit(f"chip_smoke: the megastep capture launched the fold "
                         f"{capture_launches} times, not once")
    eager_ms = time_ms(lambda: fn(world, ring, tags, rows), 5)
    replay_ms = time_ms(graph.replay, 5)
    return {"entities": SIZES["bench_entities"], "k_max": k_max, "ring_slots": slots,
            "replays": checked, "eager_call_ms": eager_ms, "graph_replay_ms": replay_ms}


def phase_megastep(dev, card: str) -> int:
    """(a) SyncTest stress_soa 100k at d=7, megastep on against the
    per-tick runner: equal checksum streams; (b) P2P pairs at coalesce 4
    (stress_soa 1M, fixed_point), megastep on against the default runner:
    equal confirmed checksums, fixed_point's equal to a CPU megastep
    pair's; (c) the program's CUDA-graph capture.  Returns the megastep
    loops' fold launches."""
    from bevy_ggrs_tpu_torch.models import fixed_point, stress_soa

    make = lambda: stress_soa.make_app(  # noqa: E731
        n_entities=SIZES["synctest_stress_entities"], device=dev)
    frames = SIZES["megastep_synctest_frames"]
    ms = synctest(make(), frames, megastep=True, check_fold=True)
    ref = synctest(make(), frames, check_fold=True)
    if ms.pop("stream") != ref.pop("stream"):
        raise SystemExit("chip_smoke: megastep SyncTest: the checksum stream differs "
                         "from the per-tick runner's")
    emit("megastep_synctest", model="stress_soa_100k", card=card, streams_equal=True,
         megastep=ms, per_tick=ref)
    launches = ms["kernel_launches"]
    n = SIZES["p2p_stress_entities"]
    pairs = {f"stress_soa_{n}": lambda: stress_soa.make_app(n_entities=n, device=dev),
             "fixed_point": lambda: fixed_point.make_app(device=dev)}
    for seed, (name, make_app) in enumerate(pairs.items()):
        runs = {mode: megastep_pair(name, make_app, dev, seed, mode == "megastep")
                for mode in ("megastep", "default")}
        a, b = runs["megastep"].pop("agreed"), runs["default"].pop("agreed")
        shared = sorted(set(a) & set(b))
        few = SIZES["megastep_frames"] // SIZES["megastep_coalesce"] // 2
        if len(shared) < few or any(a[f] != b[f] for f in shared):
            raise SystemExit(f"chip_smoke: megastep {name}: confirmed checksums differ "
                             f"from the default runner's ({len(shared)} shared frames)")
        if name == "fixed_point":
            cpu = megastep_pair(name, lambda: fixed_point.make_app(device="cpu"),
                                torch.device("cpu"), seed, True).pop("agreed")
            on_cpu = [f for f in shared if f in cpu]
            if len(on_cpu) < few or any(a[f] != cpu[f] for f in on_cpu):
                raise SystemExit("chip_smoke: megastep fixed_point: the card's confirmed "
                                 "checksums differ from the CPU pair's")
            runs["megastep"]["frames_equal_to_cpu_pair"] = len(on_cpu)
        launches += runs["megastep"]["fold_launches"]
        for r in runs.values():
            emit("megastep_pair", card=card, agree_with_other_mode_at_frames=len(shared), **r)
    emit("megastep_capture", card=card, **megastep_capture(dev))
    return launches


def particles_pair(dev, seed: int) -> dict:
    """The reference's default particles (rate 100, ttl 120) as a P2P pair
    over phase ``megastep``'s channel (prediction window 8), the loop past
    10 warm-up frames under ``set_sync_debug_mode("error")``: no desync,
    equal confirmed checksums; peer 0's game recorded and replayed through
    ``ReplaySession`` on the card to the same checksums."""
    from bevy_ggrs_tpu_torch import GgrsRunner, InputRecorder, ReplaySession
    from bevy_ggrs_tpu_torch.models import particles
    from bevy_ggrs_tpu_torch.ops import checksum_fold as cf

    make = lambda: particles.make_app(  # noqa: E731
        rate=SIZES["particles_rate"], ttl=SIZES["particles_ttl"], device=dev)
    net, runners, seen = channel_pair(make, seed)
    rec = InputRecorder.for_app(runners[0].app)
    confirm = runners[0].on_confirmed
    runners[0].on_advance = rec.on_advance
    runners[0].on_confirmed = lambda f: (rec.on_confirmed(f), confirm(f))
    sync_sessions(runners, net)
    kept = keep_stacks(runners)
    frames = SIZES["particles_frames"]
    warm = 10
    drive(runners, warm, net)  # the first resims' allocations
    sync(dev)
    resims0 = sum(r.resims for r in runners)
    cf.launches = 0
    cuda = dev.type == "cuda"
    t0 = time.perf_counter()
    if cuda:
        torch.cuda.set_sync_debug_mode("error")
    try:
        drive(runners, frames - warm, net)
    finally:
        if cuda:
            torch.cuda.set_sync_debug_mode("default")
    sync(dev)
    dt = time.perf_counter() - t0
    launches = cf.launches
    resims = sum(r.resims for r in runners) - resims0
    for r in runners:
        r.finish()
    agreed = agreed_checksums(seen)
    stack_shapes = check_stacks("particles pair", kept) if cuda else []
    del kept
    result = {"capacity": runners[0].app.reg.capacity, "frames": frames, "seconds": dt,
              "sync_debug_mode": "error" if cuda else "default",
              "frames_per_s_per_peer": [(r.frame - warm) / dt for r in runners],
              "rollbacks": [r.rollbacks for r in runners], "resim_calls": resims,
              "fold_launches": launches, "desyncs": [len(desyncs(r)) for r in runners],
              "confirmed_frames_agreed": len(agreed),
              "active_particles": int(runners[0].world.alive.sum()),
              "path_stacks_bit_exact": stack_shapes}
    if any(result["desyncs"]) or len(agreed) < frames // 2 or runners[1].rollbacks == 0 \
            or (dev.type == "cuda" and launches != resims):
        raise SystemExit(f"chip_smoke: particles pair: {result}")
    replayer = GgrsRunner(make(), ReplaySession(rec))
    replayed = {}
    while not replayer.session.finished:
        replayer.tick()
        replayed[replayer.frame] = replayer._world_checksum
    # a replay labels the initial state with the first recorded frame, so
    # its frame f + 1 holds the live frame f (as in the JAX package)
    same = [f for f in agreed if f + 1 in replayed]
    if len(same) < frames // 2 or any(replayed[f + 1]() != agreed[f] for f in same):
        raise SystemExit(f"chip_smoke: particles replay differs from the live game "
                         f"({len(same)} frames compared)")
    result["replay_frames_equal"] = len(same)
    return result


def crowd_lanes(dev) -> dict:
    """A 16-lane wave of crowd lobbies against each lobby's solo resim:
    reported, not failed (long reductions may round differently with the
    lane count); a ``vmap`` fallback fails."""
    from bevy_ggrs_tpu_torch.models import crowd
    from bevy_ggrs_tpu_torch.ops import batch as TB
    from bevy_ggrs_tpu_torch.ops import resim as R
    from bevy_ggrs_tpu_torch.utils.tree import tree_flatten

    app = crowd.make_app(n_per_team=SIZES["crowd_per_team"], device=dev)
    m, k = SIZES["crowd_lanes"], SIZES["crowd_lane_k"]
    rng = np.random.default_rng(8)
    inputs = on_device(rng.integers(0, 16, (m, k, 2)).astype(np.uint8), dev)
    status = on_device(np.zeros((m, k, 2), np.int8), dev)
    starts = on_device(np.arange(m, dtype=np.int32) * 37, dev)
    world = app.init_state()
    # distinct worlds: lobby b starts from b frames of its own inputs
    worlds = []
    for b in range(m):
        w = world
        if b:
            w, _, _ = app.resim_fn(world, inputs[b, :1].expand(b, 2), status[b, :1].expand(
                b, 2), 0)
        worlds.append(w)
    R.vmap_fallbacks = 0
    finals, stacked, checks = TB.make_batched_resim_fn(app)(
        TB.stack_worlds(worlds), inputs, status, starts)
    fallbacks = R.vmap_fallbacks
    wave_stack = check_fold_on("crowd lanes", app.reg, flat_branches(stacked))
    equal, max_diff = 0, 0.0
    for b in range(m):
        one, one_stacked, one_checks = app.resim_fn(worlds[b], inputs[b], status[b],
                                                    int(starts[b]))
        same = torch.equal(one_checks, checks[b]) and all(
            torch.equal(x, y) for x, y in zip(tree_flatten(one_stacked),
                                              tree_flatten(TB.unstack_world(stacked, b))))
        equal += same
        for x, y in zip(tree_flatten(one_stacked), tree_flatten(TB.unstack_world(stacked, b))):
            if x.dtype.is_floating_point:
                max_diff = max(max_diff, float((x - y).abs().max()))
    if fallbacks:
        raise SystemExit(f"chip_smoke: crowd lanes: {fallbacks} vmap fallbacks")
    # which of the step's reductions rounds otherwise on the lane axis: each
    # on one world, alone and as lane 0 of 16 identical lanes under vmap
    w = worlds[-1]
    mf = (w.alive & ~w.despawn_pending & w.has["team"]).to(torch.float32)
    pos, team = w.comps["pos"], w.comps["team"].long()
    onehot = (team[:, None] == torch.arange(2, device=dev)).to(torch.float32) * mf[:, None]

    def reductions(pos, mf, onehot):
        return (torch.matmul(onehot.transpose(0, 1), pos), onehot.sum(dim=0), mf.sum(),
                (pos * mf[:, None]).sum(dim=0))

    solo = reductions(pos, mf, onehot)
    lanes = torch.func.vmap(reductions)(*(t.expand(m, *t.shape) for t in (pos, mf, onehot)))
    names = ("team_sum_matmul", "team_count_sum", "total_sum", "center_of_mass_sum")
    ops = {n: torch.equal(a, b[0]) for n, a, b in zip(names, solo, lanes)}
    return {"lanes": m, "k": k, "entities": 2 * SIZES["crowd_per_team"],
            "lanes_bit_equal_to_solo": equal, "max_abs_float_diff": max_diff,
            "vmap_fallbacks": fallbacks, "reductions_bit_equal_on_lane_axis": ops,
            "wave_stack_bit_exact": wave_stack}


def room_pair(dev) -> dict:
    """A fixed_point pair over ``RoomServer`` and ``RoomSocket``s on
    loopback (relay mode), ``room_frames`` frames: in sync."""
    from bevy_ggrs_tpu_torch import (
        DesyncDetection,
        GgrsRunner,
        PlayerType,
        RoomServer,
        RoomSocket,
        SessionBuilder,
        assign_handles,
        wait_for_players,
    )
    from bevy_ggrs_tpu_torch.models import fixed_point

    server = RoomServer(host="127.0.0.1")
    socks = [RoomSocket(server.local_addr, "smoke", peer_id=f"peer-{i}", mode="relay",
                        host="127.0.0.1") for i in range(2)]
    try:
        for sock in socks:
            wait_for_players(sock, 2, timeout_s=10.0, server=server)
        runners, seen = [], []
        for i, sock in enumerate(socks):
            app = fixed_point.make_app(device=dev)
            b = (SessionBuilder.for_app(app).with_input_delay(1)
                 .with_desync_detection_mode(DesyncDetection.on(1)))
            for h, peer in assign_handles(sock).items():
                b = (b.add_player(PlayerType.LOCAL, h) if peer == sock.peer_id
                     else b.add_player(PlayerType.REMOTE, h, peer))
            holder = []
            runners.append(GgrsRunner(app, b.start_p2p_session(sock),
                                      read_inputs=session_frame_inputs(i, holder)))
            holder.append(runners[-1])
            seen.append(record_confirmed(runners[-1]))
        for _ in range(20000):
            server.poll()
            for r in runners:
                r.update(0.0)
            if all(r.session.current_state().value == "running" for r in runners):
                break
            time.sleep(0.0005)
        else:
            raise SystemExit("chip_smoke: the room pair never synchronized")
        kept = keep_stacks(runners)
        for _ in range(SIZES["room_frames"]):
            server.poll()
            for r in runners:
                r.update(1.0 / 60.0)
        for r in runners:
            r.finish()
        agreed = agreed_checksums(seen)
        result = {"frames": [r.frame for r in runners], "mode": "relay",
                  "desyncs": [len(desyncs(r)) for r in runners],
                  "confirmed_frames_agreed": len(agreed),
                  "path_stacks_bit_exact": (check_stacks("room pair", kept)
                                            if dev.type == "cuda" else [])}
        if any(result["desyncs"]) or len(agreed) < SIZES["room_frames"] // 2:
            raise SystemExit(f"chip_smoke: room pair out of sync: {result}")
        return result
    finally:
        server.close()
        for sock in socks:
            sock.close()


def phase_models(dev, card: str) -> int:
    """particles (the default pair, then 1M capacity under SyncTest with
    and without ``QuantizeStrategy``, its draws against the CPU's, a
    checkpoint, a replay), crowd (SyncTest and a 16-lane wave), pong
    (SyncTest to a score) and a room pair.  Returns the fold launches of
    the driven runs."""
    import io

    from bevy_ggrs_tpu_torch import GgrsRunner, SessionBuilder
    from bevy_ggrs_tpu_torch.models import crowd, particles, pong
    from bevy_ggrs_tpu_torch.snapshot import persist
    from bevy_ggrs_tpu_torch.utils import threefry

    pair = particles_pair(dev, seed=3)
    emit("models_particles_pair", card=card, **pair)
    launches = pair["fold_launches"]
    big = {}
    for quantize in (False, True):
        app = particles.make_app(rate=SIZES["particles_big_rate"], ttl=SIZES["particles_ttl"],
                                 quantize=quantize, device=dev)
        r = synctest(app, SIZES["particles_big_frames"], keep_runner=True, check_fold=True)
        r.pop("stream")
        runner = r.pop("runner")
        launches += r["kernel_launches"]
        zeros = on_device(np.zeros((8, 2), np.uint8), dev)
        prof = device_profile(lambda: app.resim_fn(runner.world, zeros, zeros.to(torch.int8),
                                                   runner.frame), 2)
        r["device_events_per_frame"] = prof["device_events_per_call"] / 8
        r["host_ms_per_frame"] = prof["host_ms_per_call"] / 8
        r["device_ms_per_frame"] = prof["device_ms_per_call"] / 8
        # one frame's draws alone (the step's four threefry hashes on the
        # live counter): their share of the frame's events and times
        counter = runner.world.res["rng_counter"]

        def draws(app=app, counter=counter):
            kv, kp = threefry.split(threefry.fold_in(threefry.prng_key(app.seed), counter))
            return (threefry.uniform(kv, (SIZES["particles_big_rate"], 3), -2.0, 2.0),
                    threefry.uniform(kp, (SIZES["particles_big_rate"],)))

        drawn = device_profile(draws, 16)
        r["draws"] = {
            "device_events_per_frame": drawn["device_events_per_call"],
            "host_ms_per_frame": drawn["host_ms_per_call"],
            "device_ms_per_frame": drawn["device_ms_per_call"],
            "share_of_device_events": (drawn["device_events_per_call"]
                                       / r["device_events_per_frame"]),
            "share_of_host_ms": drawn["host_ms_per_call"] / r["host_ms_per_frame"],
            "share_of_device_ms": (drawn["device_ms_per_call"] / r["device_ms_per_frame"]
                                   if r["device_ms_per_frame"] else None)}
        big[quantize] = (app, runner)
        emit("models_particles_synctest", card=card, capacity=app.reg.capacity,
             rate=SIZES["particles_big_rate"], quantize=quantize, **r)
    # the draws on the card against the same functions on the CPU
    rate = SIZES["particles_big_rate"]
    for c in (0, 7, 2**31 + 5, 2**32 - 1):
        draws = []
        for d in (dev, torch.device("cpu")):
            key = threefry.fold_in(threefry.prng_key(0), torch.tensor(c, device=d))
            kv, kp = threefry.split(key)
            draws.append([threefry.uniform(kv, (rate, 3), -2.0, 2.0).cpu(),
                          threefry.uniform(kp, (rate,)).cpu()])
        if not all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                   for a, b in zip(*draws)):
            raise SystemExit(f"chip_smoke: particles' draws on the card differ from "
                             f"the CPU's at counter {c}")
    # checkpoint the 1M world, load it back, advance both
    app, runner = big[False]
    buf = io.BytesIO()
    t0 = time.perf_counter()
    persist.save_world(buf, app.reg, runner.world, frame=runner.frame)
    save_s = time.perf_counter() - t0
    buf.seek(0)
    ck = persist.load_checkpoint(buf, app.reg, device=dev)
    digest = persist.schema_digest(app.reg)
    inputs = on_device(np.full((8, 2), 8, np.uint8), dev)
    status = on_device(np.zeros((8, 2), np.int8), dev)
    a = app.resim_fn(runner.world, inputs, status, runner.frame)[2]
    b = app.resim_fn(ck.world, inputs, status, ck.frame)[2]
    if ck.frame != runner.frame or not torch.equal(a, b) or digest != PARTICLES_BIG_DIGEST:
        raise SystemExit(f"chip_smoke: the particles checkpoint does not resume the "
                         f"same game (digest {digest})")
    emit("models_checkpoint", card=card, capacity=app.reg.capacity,
         bytes=buf.getbuffer().nbytes, save_s=save_s, frames_advanced=8,
         checksums_equal=True, schema_digest=digest)
    del big, app, runner, ck
    gc.collect()
    # crowd: SyncTest and a wave of lobbies
    r = synctest(crowd.make_app(n_per_team=SIZES["crowd_per_team"], device=dev),
                 SIZES["crowd_frames"], check_fold=True)
    r.pop("stream")
    launches += r["kernel_launches"]
    emit("models_crowd", card=card, entities=2 * SIZES["crowd_per_team"], synctest=r,
         wave=crowd_lanes(dev))
    # pong: player 1 hides at the top until a ball gets past it
    r = synctest(pong.make_app(device=dev), SIZES["pong_frames"], keep_runner=True,
                 read_inputs=lambda hs: {0: np.uint8(0), 1: np.uint8(pong.UP)},
                 check_fold=True)
    r.pop("stream")
    score = r.pop("runner").world.res["score"].tolist()
    launches += r["kernel_launches"]
    if sum(score) < 1:
        raise SystemExit(f"chip_smoke: pong reached no score in {SIZES['pong_frames']} "
                         "frames")
    emit("models_pong", card=card, score=score, **r)
    emit("models_room", card=card, **room_pair(dev))
    return launches


# -- the fleet: scheduler, workers, lobby sims, migration and failover -----------


class LobbyCounts:
    """Counts, while entered, every ``LobbySim`` chunk dispatch (a
    ``step`` that advanced frames), its frames and host ms by lobby kind
    (a ``stress_soa`` lobby's entity count, or the app), and every
    ``checksum`` call: the fold launches the fleet's
    lobbies make.  Patches the class, so lobbies the workers build count."""

    def __enter__(self):
        from bevy_ggrs_tpu_torch.fleet import lobby

        cls, counts = lobby.LobbySim, self
        self._cls, self._step, self._checksum = cls, cls.step, cls.checksum
        self.chunks = self.frames = self.checksums = 0
        self.ms_by_entities = {}

        def step(sim, max_frames=lobby.LOBBY_CHUNK):
            t0 = time.perf_counter()
            k = counts._step(sim, max_frames)
            if k:
                counts.chunks += 1
                counts.frames += k
                key = sim.spec.entities if sim.spec.app == "stress_soa" else sim.spec.app
                row = counts.ms_by_entities.setdefault(key, [0, 0.0])
                row[0] += 1
                row[1] += (time.perf_counter() - t0) * 1e3
            return k

        def checksum(sim):
            counts.checksums += 1
            return counts._checksum(sim)

        cls.step, cls.checksum = step, checksum
        return self

    def __exit__(self, *exc):
        self._cls.step, self._cls.checksum = self._step, self._checksum


def fleet_pump(sched, workers, cond, timeout_s: float, what: str, each=None) -> None:
    """Poll the scheduler and ``workers`` until ``cond()``; ``each()`` runs
    after every round; raises on the timeout."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        sched.poll()
        for w in workers:
            w.poll()
        if each is not None:
            each()
        if cond():
            return
        time.sleep(0.001)
    raise SystemExit(f"chip_smoke: fleet: timed out waiting for {what}: "
                     f"{sched.snapshot()['lobbies']}")


def fleet_overflow(sched, workers, spec) -> str:
    """SUBMIT ``spec`` over the wire from a ``FleetClient`` while the fleet
    is pumped; the REJECT reason (or the placing worker's id)."""
    import threading

    from bevy_ggrs_tpu_torch.fleet import FleetClient

    cli = FleetClient(sched.local_addr)
    verdict = {}

    def ask():
        verdict["worker"] = cli.submit(spec, timeout_s=30)
        verdict["reason"] = cli.last_reject

    t = threading.Thread(target=ask)
    t.start()
    while t.is_alive():
        sched.poll()
        for w in workers:
            w.poll()
        time.sleep(0.002)
    t.join()
    cli.close()
    return verdict["reason"] if verdict["worker"] is None else f"placed:{verdict['worker']}"


def fleet_controls(specs, dev, ext_rows=None) -> dict:
    """Each spec's final checksum (hex) from an unmigrated in-process lobby
    on ``dev``; an external lobby gets ``ext_rows`` as its inputs."""
    from bevy_ggrs_tpu_torch.fleet import LobbySim, checksum_hex

    out = {}
    for spec in specs:
        sim = LobbySim(spec, device=dev)
        if spec.input_mode == "external":
            for f, row in enumerate(ext_rows, start=1):
                sim.submit_input(f, row)
        sim.run_to(spec.target_frames)
        if sim.frame != spec.target_frames:
            raise SystemExit(f"chip_smoke: fleet control {spec.lobby_id} stopped at "
                             f"{sim.frame}")
        out[spec.lobby_id] = checksum_hex(sim.checksum())
    return out


def fleet_chunk_checks(specs, dev) -> list:
    """The fold held to its plain version on a lobby chunk's own stack
    (``[LOBBY_CHUNK, N]``) and on the ``[1, N]`` stack of its checksum
    call, one lobby per spec, outside any counted window; and
    ``spec_est_bytes`` equal to the lobby's world tensors' bytes there."""
    from bevy_ggrs_tpu_torch.fleet import LobbySim, spec_est_bytes
    from bevy_ggrs_tpu_torch.ops import checksum_fold as cf
    from bevy_ggrs_tpu_torch.utils.tree import tree_map

    rows = []
    for spec in specs:
        sim = LobbySim(spec, device=dev)
        est, want = sim.est_bytes(), spec_est_bytes(spec)
        if est != want:
            raise SystemExit(f"chip_smoke: fleet: {spec.lobby_id} world holds {est} B on "
                             f"the card, spec_est_bytes says {want}")
        fn, kept = sim.app.packed_resim_fn, []

        def keeping(state, packed, fn=fn, kept=kept):
            out = fn(state, packed)
            kept.append(out[1])
            return out

        sim.app.__dict__["packed_resim_fn"] = keeping
        if spec.input_mode == "external":
            for f in range(1, 6):
                sim.submit_input(f, np.zeros((sim.app.num_players,), sim.app.input_dtype))
        sim.step()
        stacks = [kept[0], tree_map(lambda a: a[None], sim.world)]
        for stacked in stacks:
            args = fold_inputs(sim.app.reg, stacked)
            if dev.type == "cuda" and not torch.equal(cf.checksum_fold(*args),
                                                      cf.checksum_fold_plain(*args)):
                raise SystemExit(f"chip_smoke: fleet: the fold differs from its plain "
                                 f"version on {spec.lobby_id}'s stack "
                                 f"{list(stacked.alive.shape)}")
            rows.append({"lobby": spec.app, "entities": spec.entities,
                         "stack": list(stacked.alive.shape), "est_bytes": est})
    return rows


def fleet_chunk_profile(spec, dev, chunks: int) -> dict:
    """One lobby's chunks under the profiler (:func:`warm_profile`): the
    staging queue's commits (the host's census of uploads), host-to-device
    copies per chunk (pinned and pageable), device events and device ms
    per chunk, host ms per chunk."""
    from bevy_ggrs_tpu_torch.fleet import LobbySim

    sim = LobbySim(spec, device=dev)
    sim.step()
    sim.step()
    commit, commits = sim._stage.commit, [0]

    def counting(view):
        commits[0] += 1
        return commit(view)

    sim._stage.commit = counting
    prof, wall_ms = warm_profile(sim.step, chunks)
    commits[0] -= 1  # the warm-up chunk's
    counts, busy_us = copy_counts(prof)
    return {"chunks": chunks, "entities": spec.entities, "commits": commits[0], **counts,
            "pinned_htod_per_chunk": counts["htod_pinned"] / chunks,
            "launches_per_chunk": counts["launches"] / chunks,
            "host_ms_per_chunk": wall_ms / chunks,
            "device_busy_ms_per_chunk": busy_us / 1e3 / chunks,
            "idle_share": 1 - busy_us / 1e3 / wall_ms}


def fleet_in_process(dev, card: str) -> int:
    """(a) The fleet in one process on the card (module docstring, phase
    17); returns the fold launches its lobbies made."""
    from bevy_ggrs_tpu_torch import telemetry
    from bevy_ggrs_tpu_torch.fleet import (FleetScheduler, FleetWorker, LobbySpec,
                                           spec_est_bytes)
    from bevy_ggrs_tpu_torch.ops import checksum_fold as cf

    target = SIZES["fleet_frames"]
    specs = [LobbySpec(lobby_id=f"s{i}", entities=SIZES["server_entities"], seed=i,
                       target_frames=target) for i in range(SIZES["fleet_small_lobbies"])]
    big = LobbySpec(lobby_id="big", entities=SIZES["svc_entities"], seed=11,
                    target_frames=target)
    ext = LobbySpec(lobby_id="ext", app="box_game", players=2, seed=12,
                    target_frames=target, input_mode="external")
    specs += [big, ext]
    ext_rows = np.random.default_rng(12).integers(0, 16, (target, 2)).astype(np.uint8)
    checks = fleet_chunk_checks([specs[0], big, ext], dev)
    prof = (fleet_chunk_profile(specs[0], dev, SIZES["fleet_profile_chunks"])
            if dev.type == "cuda" else None)
    # the commits are the exact census; the trace must agree, but may miss
    # one chunk's copy record, as in phase pipeline (1 window in 20 behind
    # a warm-up call on the H100)
    if prof is not None and (prof["commits"] != prof["chunks"] or prof["htod_pageable"]
                             or prof["htod"] != prof["htod_pinned"]
                             or not prof["chunks"] - 1 <= prof["htod_pinned"] <= prof["chunks"]):
        raise SystemExit(f"chip_smoke: fleet: not one pinned upload per chunk: {prof}")

    telemetry.reset()
    telemetry.enable()
    sched = FleetScheduler(worker_timeout_s=8.0)
    cap = SIZES["fleet_capacity"]
    workers = [FleetWorker(f"w{i}", sched.local_addr, capacity=cap,
                           ckpt_every_frames=SIZES["fleet_ckpt_every"], device=dev)
               for i in range(2)]
    live = list(workers)
    rounds = {}  # (lobby, frame) -> re-ship rounds seen at a worker

    def sample():
        for w in live:
            for lid, h in w.lobbies.items():
                if h.shipment is not None:
                    key = (lid, h.shipment.frame)
                    rounds[key] = max(rounds.get(key, 0), h.shipment.rounds)

    try:
        for w in workers:
            w.register()
        fleet_pump(sched, live, lambda: len(sched.workers) == 2, 60, "2 workers")
        if dev.type == "cuda":
            gc.collect()
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        cf.launches = 0
        with LobbyCounts() as counts:
            t0 = time.perf_counter()
            for spec in specs:
                ok, who = sched.submit(spec)
                if not ok:
                    raise SystemExit(f"chip_smoke: fleet: {spec.lobby_id} rejected ({who})")
            recs = {s.lobby_id: sched.lobbies[s.lobby_id] for s in specs}
            fleet_pump(sched, live, lambda: all(r.state in ("running", "done")
                                                for r in recs.values()),
                       120, "all lobbies placed")
            host = next(w for w in live if "ext" in w.lobbies)
            for f, row in enumerate(ext_rows, start=1):
                host.lobbies["ext"].sim.submit_input(f, row)
            # fill the free slots with inert external lobbies, then a SUBMIT
            # over the wire must come back REJECT(capacity)
            fillers = [f"fill{i}" for i in range(2 * cap - len(specs))]
            for fid in fillers:
                ok, who = sched.submit(LobbySpec(lobby_id=fid, entities=16,
                                                 target_frames=1_000_000,
                                                 input_mode="external"))
                if not ok:
                    raise SystemExit(f"chip_smoke: fleet: filler {fid} rejected ({who})")
            reject = fleet_overflow(sched, live, LobbySpec(lobby_id="overflow", entities=16))
            for fid in fillers:
                sched.drop(fid)
            movers = [specs[0].lobby_id, big.lobby_id]
            fleet_pump(sched, live, lambda: min(recs[m].frame for m in movers) >= target // 3,
                       300, "a third of the run", sample)
            srcs = {m: recs[m].worker_id for m in movers}
            for m in movers:
                if not sched.migrate(m):
                    raise SystemExit(f"chip_smoke: fleet: migrate({m}) found no destination")
            resume_rounds = {}

            def migrated():
                sample()
                for m in movers:
                    if recs[m].state == "running" and recs[m].worker_id != srcs[m]:
                        resume_rounds.setdefault(m, recs[m].resume_rounds)
                return len(resume_rounds) == len(movers)

            fleet_pump(sched, live, migrated, 300, "both migrations")
            # close the worker hosting the most running lobbies, once each of
            # them has a confirmed checkpoint past frame 0 at the scheduler
            victim = max(live, key=lambda w: sum(r.worker_id == w.worker_id
                                                 and r.state == "running"
                                                 for r in recs.values()))
            mine = [r for r in recs.values()
                    if r.worker_id == victim.worker_id and r.state == "running"]
            fleet_pump(sched, live, lambda: max(r.frame for r in recs.values()) >= target // 2
                       and all(r.ckpt_frame > 0 and r.ckpt_blob is not None for r in mine),
                       300, "confirmed checkpoints on the victim", sample)
            killed_at = {r.lobby_id: r.frame for r in mine if r.state == "running"}
            if not killed_at:
                raise SystemExit("chip_smoke: fleet: the victim's lobbies finished before "
                                 "the kill")
            sched.worker_timeout_s = 2.0
            victim.close()
            live.remove(victim)
            fleet_pump(sched, live, lambda: all(r.state == "done" for r in recs.values()),
                       600, "every lobby to finish", sample)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        launches = cf.launches
        peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None
    finally:
        for w in workers:
            w.close()
        sched.close()
        telemetry.disable()
    want = fleet_controls(specs, dev, ext_rows)
    got = {lid: r.final_checksum for lid, r in recs.items()}
    events = sched.events
    mig = [e for e in events if e["event"] == "migrate_ok"]
    fo = [e for e in events if e["event"] == "failover"]
    series = telemetry.summary()["metrics"]["lobby_migrations_total"]["series"]
    telemetry.reset()
    fail = []
    if got != want:
        fail.append(f"final checksums differ from the controls: {got} != {want}")
    if reject != "capacity":
        fail.append(f"overflow verdict {reject!r}, not a 'capacity' REJECT")
    if series.get("outcome=ok", 0) < 1 or len(mig) != len(movers):
        fail.append(f"migrations: {series}, {mig}")
    if series.get("outcome=failover", 0) < 1 or not fo or any(e["frame"] <= 0 for e in fo):
        fail.append(f"failovers: {series}, {fo}")
    if dev.type == "cuda" and launches != counts.chunks + counts.checksums:
        fail.append(f"{launches} fold launches for {counts.chunks} chunks and "
                    f"{counts.checksums} checksum calls")
    if fail:
        raise SystemExit(f"chip_smoke: fleet (a): {'; '.join(fail)}")
    big_rounds = {f"{lid}@{frame}": n for (lid, frame), n in sorted(rounds.items())
                  if lid == big.lobby_id}
    rmem = Path("/proc/sys/net/core/rmem_max")
    emit("fleet_in_process", card=card, lobbies=len(specs), capacity=cap,
         entities={s.lobby_id: s.entities if s.app == "stress_soa" else s.app
                   for s in specs}, target_frames=target,
         seconds=seconds, lobby_frames=counts.frames,
         lobby_frames_per_s=counts.frames / seconds,
         frames_per_s_per_lobby=counts.frames / seconds / len(specs),
         chunks=counts.chunks, checksum_calls=counts.checksums, fold_launches=launches,
         ms_per_chunk={str(n): ms / c for n, (c, ms) in counts.ms_by_entities.items()},
         migrations=[{k: e[k] for k in ("lobby", "src", "dst", "frame", "downtime_ms")}
                     for e in mig],
         failovers=[{k: e[k] for k in ("lobby", "src", "dst", "frame")} for e in fo],
         killed_at_frames=killed_at, migration_series=series, overflow_reject=reject,
         ckpt_bytes={s.lobby_id: len(sched.lobbies[s.lobby_id].ckpt_blob or b"")
                     for s in (specs[0], big)},
         big_worker_reship_rounds=big_rounds, big_resume_rounds=resume_rounds.get("big"),
         resume_rounds=resume_rounds,
         rmem_max=int(rmem.read_text()) if rmem.exists() else None,
         max_memory_allocated_bytes=peak, est_bytes={s.lobby_id: spec_est_bytes(s)
                                                    for s in (specs[0], big, ext)},
         chunk_profile=prof, chunk_stacks_bit_exact=checks,
         final_checksums_equal_controls=len(want),
         events=sorted({e["event"] for e in events}))
    return launches



def fleet_subprocesses(dev, card: str) -> None:
    """(b) The JAX bench's fleet stage (``bench.py`` ``stage_fleet``) with
    the port's CLIs: two ``scripts/torch_fleet_worker.py`` processes on
    ``dev`` under an in-process scheduler; a live migration, a SIGSTOP
    liveness alert and its resolve, the fleet's HTTP surface, a SIGKILL
    failover, an overflow REJECT, a three-participant merged trace, and
    every final checksum equal to an in-process control on ``dev``."""
    import os
    import signal
    import tempfile
    import urllib.request

    from bevy_ggrs_tpu_torch import telemetry
    from bevy_ggrs_tpu_torch.fleet import FleetScheduler, LobbySpec, start_fleet_exporter

    target, entities = SIZES["fleet_cli_frames"], SIZES["fleet_cli_entities"]
    n_lobbies, cap = SIZES["fleet_cli_lobbies"], SIZES["fleet_cli_capacity"]
    wait_s = SIZES["fleet_cli_wait_s"]
    telemetry.reset()
    telemetry.enable()
    # a fresh worker's first chunk pays for the CUDA context, the library
    # load and the allocator's growth: the JAX bench's 8 s timeout
    sched = FleetScheduler(worker_timeout_s=8.0)
    port = sched.local_addr[1]
    exporter = start_fleet_exporter(sched.observer, port=0)
    tmp = tempfile.TemporaryDirectory(prefix="fleet_cli_")
    procs, logs = {}, {}

    def spawn(wid):
        logs[wid] = open(os.path.join(tmp.name, f"{wid}.log"), "w")
        procs[wid] = subprocess.Popen(
            [sys.executable, str(HERE / "scripts" / "torch_fleet_worker.py"),
             "--scheduler", f"127.0.0.1:{port}", "--worker-id", wid,
             "--capacity", str(cap), "--ckpt-every", "40", "--pace-fps", "240",
             "--device", dev.type,
             "--trace-out", os.path.join(tmp.name, f"{wid}.trace.json"),
             "--trace-every", "0.5"],
            cwd=HERE, stdout=logs[wid], stderr=subprocess.STDOUT)

    def pump_until(cond, what):
        deadline = time.monotonic() + wait_s
        while time.monotonic() < deadline:
            sched.poll()
            if cond():
                return
            dead = [w for w, p in procs.items() if p.poll() is not None and w != victim[0]]
            if dead:
                break
            time.sleep(0.002)
        tails = {w: Path(tmp.name, f"{w}.log").read_text()[-2000:] for w in procs}
        raise SystemExit(f"chip_smoke: fleet (b): no {what}: {sched.snapshot()['lobbies']}; "
                         f"worker logs: {tails}")

    victim = [None]
    t0 = time.perf_counter()
    try:
        spawn("wA")
        spawn("wB")
        pump_until(lambda: len(sched.workers) == 2, "2 workers registered")
        t_registered = time.perf_counter() - t0
        # the last lobby runs 4x longer, so it is still mid-game when its
        # worker is killed
        specs = [LobbySpec(lobby_id=f"fl{i}", entities=entities, seed=i,
                           target_frames=target * (4 if i == n_lobbies - 1 else 1))
                 for i in range(n_lobbies)]
        for spec in specs:
            ok, who = sched.submit(spec)
            if not ok:
                raise SystemExit(f"chip_smoke: fleet (b): {spec.lobby_id} rejected ({who})")
        pump_until(lambda: all(sched.lobbies[s.lobby_id].state in ("running", "done")
                               for s in specs), "placement")
        fillers = [f"fill{i}" for i in range(2 * cap - n_lobbies)]
        for fid in fillers:
            ok, who = sched.submit(LobbySpec(lobby_id=fid, entities=16,
                                             target_frames=1_000_000, input_mode="external"))
            if not ok:
                raise SystemExit(f"chip_smoke: fleet (b): filler {fid} rejected ({who})")
        reject = fleet_overflow(sched, [], LobbySpec(lobby_id="overflow", entities=16))
        if reject != "capacity":
            raise SystemExit(f"chip_smoke: fleet (b): overflow verdict {reject!r}")
        for fid in fillers:
            sched.drop(fid)
        mig = specs[-1].lobby_id
        rec = sched.lobbies[mig]
        pump_until(lambda: rec.frame >= target // 3, f"{mig} at frame {target // 3}")
        src = rec.worker_id
        if not sched.migrate(mig):
            raise SystemExit("chip_smoke: fleet (b): migrate() found no destination")
        pump_until(lambda: rec.state == "running" and rec.worker_id != src, "the migration")
        # SIGSTOP the migration source: exactly one liveness fire, which
        # resolves after SIGCONT; the HTTP surface answers meanwhile
        t_stop = time.monotonic()
        os.kill(procs[src].pid, signal.SIGSTOP)

        def fires():
            return [a for a in sched.observer.alert_history()
                    if a["slo_id"] == "heartbeat_liveness" and a["subject"] == src
                    and a["state"] == "fire" and a["t"] >= t_stop]

        pump_until(lambda: bool(fires()), f"a liveness alert on stopped {src}")
        alert_ms = (fires()[0]["t"] - t_stop) * 1e3
        base = f"http://127.0.0.1:{exporter.port}"
        with urllib.request.urlopen(base + "/fleet", timeout=10) as r:
            fleet_json = json.load(r)
        with urllib.request.urlopen(base + "/qos", timeout=10) as r:
            qos_json = json.load(r)
        with urllib.request.urlopen(base + "/metrics", timeout=10) as r:
            metrics_text = r.read().decode("utf-8")
        http_fail = []
        if fleet_json.get("schema") != "fleet/v1" or not all(
                (fleet_json["workers"].get(w) or {}).get("series", {}).get("qos_floor")
                for w in ("wA", "wB")):
            http_fail.append("/fleet")
        if not any(a["slo_id"] == "heartbeat_liveness" and a["subject"] == src
                   for a in fleet_json.get("alerts", {}).get("active", [])):
            http_fail.append("/fleet active alert")
        if qos_json.get("schema") != "fleet-qos/v1":
            http_fail.append("/qos")
        if not all(f'worker="{w}"' in metrics_text for w in ("wA", "wB")):
            http_fail.append("/metrics worker= labels")
        if http_fail:
            raise SystemExit(f"chip_smoke: fleet (b): HTTP surface: {http_fail}")
        os.kill(procs[src].pid, signal.SIGCONT)
        pump_until(lambda: not any(a["slo_id"] == "heartbeat_liveness"
                                   and a["subject"] == src
                                   for a in sched.observer.active_alerts()),
                   "the liveness alert to resolve")
        if len(fires()) != 1:
            raise SystemExit(f"chip_smoke: fleet (b): {len(fires())} liveness fires for "
                             f"{src}, not one")
        # SIGKILL the long lobby's worker once a confirmed checkpoint is in
        # hand and the lobby is still mid-game
        pump_until(lambda: rec.state == "running" and rec.ckpt_blob is not None,
                   "a confirmed checkpoint of the long lobby")
        if rec.frame >= specs[-1].target_frames:
            raise SystemExit("chip_smoke: fleet (b): the long lobby finished before the kill")
        victim[0] = rec.worker_id
        procs[victim[0]].kill()
        procs[victim[0]].wait(timeout=30)
        pump_until(lambda: all(sched.lobbies[s.lobby_id].state == "done" for s in specs),
                   "every lobby to finish")
        seconds = time.perf_counter() - t0
        events = list(sched.events)
        failovers = [e for e in events if e["event"] == "failover"]
        if not failovers or any(e.get("frame", 0) <= 0 for e in failovers):
            raise SystemExit(f"chip_smoke: fleet (b): failovers {failovers}")
        # the three-participant trace: the scheduler's, then both workers'
        # last dumps (the victim's from before its kill)
        merged = telemetry.merge_traces(
            telemetry.chrome_trace(process_name="scheduler"),
            *[json.loads(Path(tmp.name, f"{w}.trace.json").read_text()) for w in ("wA", "wB")])
        errs = telemetry.validate_chrome_trace(merged)
        evs = merged["traceEvents"]
        starts = {e["id"]: e for e in evs if e.get("cat") == "fleet_flow"
                  and e.get("name") == "migration" and e["ph"] == "s"}
        spans = [(e["ts"] - starts[e["id"]]["ts"]) / 1e3 for e in evs
                 if e.get("cat") == "fleet_flow" and e.get("name") == "migration"
                 and e["ph"] == "f" and e["id"] in starts
                 and e["pid"] != starts[e["id"]]["pid"]]
        if errs or not spans:
            raise SystemExit(f"chip_smoke: fleet (b): merged trace: {errs[:5]}, "
                             f"{len(spans)} cross-pid migration flows")
        finals = {s.lobby_id: sched.lobbies[s.lobby_id].final_checksum for s in specs}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.send_signal(signal.SIGCONT)
                p.kill()
            p.wait(timeout=30)
        for f in logs.values():
            f.close()
        exporter.close()
        sched.close()
        telemetry.disable()
        tmp.cleanup()
    want = fleet_controls(specs, dev)
    if finals != want:
        raise SystemExit(f"chip_smoke: fleet (b): final checksums {finals} != controls {want}")
    downtime = [e["downtime_ms"] for e in events if e["event"] == "migrate_ok"]
    telemetry.reset()
    emit("fleet_subprocesses", card=card, workers=2, capacity=cap, lobbies=n_lobbies,
         entities=entities, target_frames=target, seconds=seconds,
         seconds_to_register=t_registered, overflow_reject=reject,
         migration_downtime_ms=downtime, migration_flow_span_ms=spans,
         failover_frames=[e["frame"] for e in failovers],
         liveness_alert_latency_ms=alert_ms, liveness_fires=1,
         trace_events=len(evs), final_checksums_equal_controls=len(want))


def phase_fleet(dev, card: str) -> int:
    """The fleet on the card: (a) in process, (b) with the port's CLIs as
    subprocesses; returns (a)'s fold launches."""
    launches = fleet_in_process(dev, card)
    fleet_subprocesses(dev, card)
    return launches


# -- multi-device: the lobby mesh, the entity mesh, the split fold ----------------


def lobby_mesh_of(dev, shards: int):
    from bevy_ggrs_tpu_torch.parallel import make_lobby_mesh

    return make_lobby_mesh(devices=[dev] * shards)


def sharded_waves(dev, card: str) -> dict:
    """Part (a): ``ShardedWaveExecutor`` over four logical shards of the
    card at stress_soa 64 lobbies x 65,536 entities, k=8 packed waves (an
    exact one, a ragged one, and one at M=62, two pad lanes): every lane's
    final state, stack and checksums bit-equal to ``BucketedWaveExecutor``'s
    on the same wave, one fold launch per shard; the ``harvest_shards``
    census; lobby-frames/s sharded against unsharded, alternating over
    pairs of chained waves."""
    from bevy_ggrs_tpu_torch import BucketedWaveExecutor, stack_worlds
    from bevy_ggrs_tpu_torch.models import stress_soa
    from bevy_ggrs_tpu_torch.ops import checksum_fold as cf
    from bevy_ggrs_tpu_torch.ops.batch import ShardedWaveExecutor
    from bevy_ggrs_tpu_torch.snapshot.lazy import BatchChecks

    m, n, k, shards = SIZES["shard_lobbies"], SIZES["shard_entities"], SIZES["bench_k"], \
        SIZES["shard_count"]
    app = stress_soa.make_app(n_entities=n, device=dev)
    ref = BucketedWaveExecutor(app, k)
    sh = ShardedWaveExecutor(app, k, lobby_mesh_of(dev, shards))
    starts = [b * 7 for b in range(m)]
    buf, _inputs, _status = wave_buffer(app, starts, k, seed=11)
    base = app.init_state()
    worlds = stack_worlds([base] * m)
    ragged = [(b * 5) % k + 1 for b in range(m)]
    waves = {"exact": (m, [k] * m), "ragged": (m, ragged),
             "pad2": (m - 2, ragged[:m - 2])}
    checked = {}
    for name, (mw, ks) in waves.items():
        from bevy_ggrs_tpu_torch.ops.packing import pack_prefix

        wbuf = buf[:mw].copy()
        for b in range(mw):
            pack_prefix(wbuf[b], starts[b], ks[b])
        w = stack_worlds([base] * mw)
        rb, rf, rs, rc = ref.run_wave_packed(w, wbuf, ks)
        sync(dev)
        cf.launches = 0
        sb, sf, ss, sc = sh.run_wave_packed(w, wbuf, ks)
        sync(dev)
        launches = cf.launches
        host = BatchChecks(sc).host()
        equal = (sb == rb and trees_equal(sf.gather(), rf) and trees_equal(ss.gather(), rs)
                 and host == rc.tolist())
        if not equal or launches != shards:
            raise SystemExit(f"chip_smoke: sharded wave {name}: bit-equal {equal}, "
                             f"{launches} fold launches for {shards} shards")
        checked[name] = {"lobbies": mw, "bucket": sb, "fold_launches": launches,
                         "lanes": len(sf), "shard_parts": len(sf.parts)}
        del rf, rs, rc, sf, ss, sc
    census = sh.harvest_shards(sh.run_wave_packed(worlds, buf, [k] * m)[1:])
    if census["devices_touched"] != shards:
        raise SystemExit(f"chip_smoke: sharded census {census}")
    ks = [k] * m
    rates = {"sharded": [], "unsharded": []}
    ws, wu = worlds, worlds
    for _ in range(SIZES["shard_pairs"]):
        for label, ex in (("unsharded", ref), ("sharded", sh)):
            sync(dev)
            t0 = time.perf_counter()
            for _ in range(SIZES["shard_iters"]):
                if label == "sharded":
                    _, ws, _, _ = ex.run_wave_packed(ws, buf, ks)
                else:
                    _, wu, _, _ = ex.run_wave_packed(wu, buf, ks)
            sync(dev)
            rates[label].append(SIZES["shard_iters"] * m * k / (time.perf_counter() - t0))
    out = {"card": card, "lobbies": m, "entities": n, "k": k, "shards": shards,
           "waves": checked, "census": census}
    for label, r in rates.items():
        out[f"{label}_lobby_frames_per_s_median"] = statistics.median(r)
        out[f"{label}_lobby_frames_per_s_min"] = min(r)
        out[f"{label}_lobby_frames_per_s_max"] = max(r)
    out["sharded_over_unsharded"] = (out["sharded_lobby_frames_per_s_median"]
                                     / out["unsharded_lobby_frames_per_s_median"])
    return out


def sharded_runner(dev, card: str) -> dict:
    """Part (b): ``BatchedRunner(mesh=make_lobby_mesh())`` on the one card
    keeps the plain executor; ``BatchedRunner(mesh=<4 logical shards>)``
    runs 14 SyncTest lobbies of stress_soa 10,000 for 40 ticks and matches
    the unsharded runner: checksums tick for tick, equal device
    dispatches, two pad lanes, and no host sync in the loop (sync debug
    mode "error"; the SyncTest comparisons run at ``finish``)."""
    from bevy_ggrs_tpu_torch import BatchedRunner, SyncTestSession
    from bevy_ggrs_tpu_torch.models import stress_soa
    from bevy_ggrs_tpu_torch.ops import checksum_fold as cf
    from bevy_ggrs_tpu_torch.ops.batch import ShardedWaveExecutor
    from bevy_ggrs_tpu_torch.parallel import make_lobby_mesh

    m, ticks = SIZES["shard_runner_lobbies"], SIZES["shard_runner_ticks"]

    def make(mesh):
        app = stress_soa.make_app(n_entities=SIZES["server_entities"], device=dev)
        sessions = [SyncTestSession(num_players=2, input_shape=(), input_dtype=np.uint8,
                                    check_distance=2, compare_interval=ticks + 8)
                    for _ in range(m)]
        return BatchedRunner(app, sessions, mesh=mesh, read_inputs=lambda b, hs: {
            h: np.uint8((b * 3 + h + br_frames[0]) % 16) for h in hs})

    br_frames = [0]
    one = make(make_lobby_mesh())
    if isinstance(one.exec, ShardedWaveExecutor) or one.planner is not None \
            or "sharded" in one.stats():
        raise SystemExit("chip_smoke: a one-card lobby mesh did not keep the plain executor")
    del one
    runs = {}
    for label, mesh in (("unsharded", None), ("sharded", lobby_mesh_of(dev, 4))):
        br = make(mesh)
        refs = []
        br_frames[0] = 0
        sync(dev)
        cf.launches = 0
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for t in range(ticks):
                br_frames[0] = t
                br.tick()
                refs.append(list(br._world_checksum))
        finally:
            torch.cuda.set_sync_debug_mode(0)
        sync(dev)
        dt = time.perf_counter() - t0
        launches = cf.launches
        br.finish()
        st = br.stats()
        runs[label] = {"sums": [[r() for r in row] for row in refs], "stats": st,
                       "launches": launches, "seconds": dt,
                       "lobby_frames_per_s": sum(st["frames"]) / dt}
    a, b = runs["unsharded"], runs["sharded"]
    sh = b["stats"]["sharded"]
    fail = []
    if a["sums"] != b["sums"]:
        fail.append("checksums differ")
    if a["stats"]["device_dispatches"] != b["stats"]["device_dispatches"]:
        fail.append("device dispatches differ")
    if sh["pad_lanes"] != 2 or sh["devices"] != 4 or a["stats"]["rollbacks"] == 0:
        fail.append(f"layout {sh}")
    if b["launches"] != 4 * b["stats"]["wave_dispatches"]:
        fail.append(f"{b['launches']} fold launches for {b['stats']['wave_dispatches']} waves")
    if fail:
        raise SystemExit(f"chip_smoke: sharded runner: {'; '.join(fail)}")
    return {"card": card, "lobbies": m, "ticks": ticks, "entities": SIZES["server_entities"],
            "sharded": sh, "device_dispatches": b["stats"]["device_dispatches"],
            "rollbacks": b["stats"]["rollbacks"], "fold_launches": b["launches"],
            "unsharded_fold_launches": a["launches"],
            "forced_readbacks": b["stats"]["readbacks"]["forced"],
            "lobby_frames_per_s": {k: v["lobby_frames_per_s"] for k, v in runs.items()},
            "checksums_compared": m * ticks}


def entity_mesh(dev, card: str) -> dict:
    """Part (c): a one-rank NCCL group on a HashStore and ``make_mesh(1,
    1)``: the sharded resim at stress_soa 1M x k=8, speculate (M=4) and
    the canonical program equal the one-device functions bit for bit; a
    SyncTest driver over the sharded world at 1M (24 ticks, check distance
    3) gives the unsharded checksums, through the sharded function."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from bevy_ggrs_tpu_torch import GgrsRunner, SyncTestSession
    from bevy_ggrs_tpu_torch.models import box_game, stress_soa
    from bevy_ggrs_tpu_torch.ops import checksum_fold as cf
    from bevy_ggrs_tpu_torch.parallel import (
        make_mesh,
        make_sharded_canonical_fn,
        make_sharded_resim_fn,
        make_sharded_speculate_fn,
        shard_world,
    )

    def full(tree):
        from bevy_ggrs_tpu_torch.utils.tree import tree_map

        return tree_map(lambda a: a.full_tensor() if isinstance(a, DTensor) else a, tree)

    mesh = make_mesh(1, 1)
    if dist.get_backend() != "nccl" or dist.get_world_size() != 1:
        raise SystemExit(f"chip_smoke: entity mesh on {dist.get_backend()}")
    n, k = SIZES["bench_entities"], SIZES["bench_k"]
    app = stress_soa.make_app(n_entities=n, device=dev)
    world = app.init_state()
    rng = np.random.default_rng(3)
    inputs = on_device(rng.integers(0, 16, (k, 2)).astype(np.uint8), dev)
    status = on_device(np.zeros((k, 2), np.int8), dev)
    want = app.resim_fn(world, inputs, status, 0)
    sharded = make_sharded_resim_fn(app, mesh)
    sync(dev)
    cf.partial_launches = cf.finalize_launches = 0
    got = sharded(world, inputs, status, 0)
    sync(dev)
    split = (cf.partial_launches, cf.finalize_launches)
    if not (trees_equal(full(got[0]), want[0]) and trees_equal(full(got[1]), want[1])
            and torch.equal(got[2], want[2])) or split != (1, 1):
        raise SystemExit(f"chip_smoke: sharded resim differs from app.resim_fn ({split})")
    resim_ms = time_ms(lambda: app.resim_fn(world, inputs, status, 0), 5)
    sharded_ms = time_ms(lambda: sharded(world, inputs, status, 0), 5)
    del got, want

    bapp = box_game.make_app(num_players=2, capacity=16, device=dev)
    bw = bapp.init_state()
    branches = np.zeros((4, k, 2), np.uint8)
    for b in range(4):
        branches[b, :, 1] = b
    bi, bs = on_device(branches, dev), on_device(np.zeros((4, k, 2), np.int8), dev)
    s0 = bapp.speculate_fn(bw, bi, bs, 0)
    s1 = make_sharded_speculate_fn(bapp, mesh)(bw, bi, bs, 0)
    capp = branched_app(lambda: box_game.make_app(device=dev), dev)
    lanes, depth = capp.canonical_branches, capp.canonical_depth
    ci = on_device(rng.integers(0, 16, (lanes, depth, 2)).astype(np.uint8), dev)
    cs = on_device(np.zeros((lanes, depth, 2), np.int8), dev)
    n_real = [3] + [depth] * (lanes - 1)
    g0 = capp.branched_fn(capp.init_state(), ci, cs, 0, n_real)
    g1 = make_sharded_canonical_fn(capp, mesh)(capp.init_state(), ci, cs, 0, n_real)
    for name, a, b in (("speculate", s0, s1), ("canonical", g0, g1)):
        if not all(trees_equal(full(x), y) for x, y in zip(b, a)):
            raise SystemExit(f"chip_smoke: sharded {name} differs from the one-device call")

    def drive(shard: bool):
        dapp = stress_soa.make_app(n_entities=n, device=dev)
        session = SyncTestSession(num_players=2, input_shape=(), input_dtype=np.uint8,
                                  check_distance=3, compare_interval=1)
        calls, kwargs = [0], {}
        if shard:
            fn = make_sharded_resim_fn(dapp, mesh)

            def counted(*args):
                calls[0] += 1
                return fn(*args)

            dapp.__dict__["resim_fn"] = dapp.__dict__["resim_fn_donated"] = counted
            kwargs["initial_state"] = shard_world(dapp, mesh, dapp.init_state())
        r = GgrsRunner(dapp, session, packed=False, read_inputs=lambda hs: {
            h: np.uint8((r.frame * 5 + h) % 16) for h in hs}, **kwargs)
        sums = []
        for _ in range(SIZES["shard_driver_ticks"]):
            r.tick()
            sums.append(r.checksum)
        r.finish()
        return sums, calls[0], r

    ref, _c, _r = drive(False)
    cf.partial_launches = cf.finalize_launches = 0
    sums, calls, runner = drive(True)
    col = next(iter(runner.world.comps.values()))
    if sums != ref or calls == 0 or not isinstance(col, DTensor):
        raise SystemExit(f"chip_smoke: sharded driver: equal {sums == ref}, {calls} calls")
    return {"card": card, "backend": dist.get_backend(), "mesh": list(mesh.mesh.shape),
            "entities": n, "k": k, "resim_bit_equal": True, "split_launches": split,
            "speculate_bit_equal": True, "canonical_bit_equal": True,
            "driver_ticks": len(sums), "driver_sharded_calls": calls,
            "driver_partial_launches": cf.partial_launches,
            "driver_finalize_launches": cf.finalize_launches,
            "driver_world_placements": [repr(p) for p in col.placements],
            "resim_ms": resim_ms, "sharded_resim_ms": sharded_ms}


def split_bound(args, blocks: int) -> dict:
    """Least times of the split pass's halves on these inputs: the
    partial pass does the one-call pass's row work (its bound, less the
    output it does not write, plus its slot sums written); the finalize
    reads the slot sums and ``next_id`` and writes the output, bound by
    bytes (its operations are a few per frame)."""
    k = args[2].shape[0]
    n_comps = len(args[0])
    whole = fold_bound(args)
    out_bytes = k * (1 + n_comps) * 2 * 8
    slot_bytes = k * (2 * n_comps + 1) * 8
    part_bytes = whole["bytes"] - out_bytes + blocks * slot_bytes
    part_ms = max(part_bytes / HBM_BYTES_PER_S * 1e3,
                  *(whole[t] for t in ("alu_ms", "fma_pipe_ms", "issue_ms")))
    fin_bytes = slot_bytes + k * 4 + out_bytes
    return {"partial_bound_ms": part_ms,
            "partial_bound_by": "bytes" if part_ms == part_bytes / HBM_BYTES_PER_S * 1e3
            else "operations",
            "finalize_bound_ms": fin_bytes / HBM_BYTES_PER_S * 1e3,
            "finalize_bound_by": "bytes", "finalize_bytes": fin_bytes}


def split_fold(dev, card: str) -> dict:
    """Part (d): the split pass at stress_soa 1M x k=8, folded as 2 and as
    4 row blocks (partials, summed slots, finalize), bit-equal to the
    one-call fold and to the plain version; the times of both paths, one
    call and back to back, and each half against its plain version."""
    from bevy_ggrs_tpu_torch.models import stress_soa
    from bevy_ggrs_tpu_torch.ops import checksum_fold as cf

    n, k = SIZES["bench_entities"], SIZES["bench_k"]
    app = stress_soa.make_app(n_entities=n, device=dev)
    stacked = stacked_of(app, app.init_state(), k)
    args = fold_inputs(app.reg, stacked)
    lanes, has, ids, alive, pending, tags, next_id, etags = args
    whole = cf.checksum_fold(*args)
    plain = cf.checksum_fold_plain(*args)
    out = {"card": card, "entities": n, "k": k, "components": len(lanes)}
    max_err = int((whole - plain).abs().max())
    for blocks in (2, 4):
        bounds = [n * j // blocks for j in range(blocks + 1)]
        parts = [([ln[:, lo:hi].contiguous() for ln in lanes],
                  [h[:, lo:hi].contiguous() for h in has], ids[:, lo:hi].contiguous(),
                  alive[:, lo:hi].contiguous(), pending[:, lo:hi].contiguous(), tags)
                 for lo, hi in zip(bounds, bounds[1:])]

        def split(parts=parts):
            slots = cf.checksum_fold_partial(*parts[0])
            for p in parts[1:]:
                slots = slots + cf.checksum_fold_partial(*p)
            return cf.checksum_fold_finalize(slots & cf.MASK32, tags, next_id, etags)

        got = split()
        plain_slots = sum(cf.checksum_fold_partial_plain(*p) for p in parts)
        got_plain = cf.checksum_fold_finalize_plain(plain_slots & cf.MASK32, tags, next_id,
                                                    etags)
        for p in parts:
            err = int((cf.checksum_fold_partial(*p) - cf.checksum_fold_partial_plain(*p))
                      .abs().max())
            max_err = max(max_err, err)
        max_err = max(max_err, int((got - whole).abs().max()),
                      int((got_plain - plain).abs().max()))
        if not (torch.equal(got, whole) and torch.equal(got_plain, plain)):
            raise SystemExit(f"chip_smoke: the split fold over {blocks} blocks differs")
        out[f"blocks_{blocks}_ms"] = time_ms(split, SIZES["kernel_reps"])
        out[f"blocks_{blocks}_back_to_back_ms"] = run_ms(split, SIZES["kernel_reps"])
    slots = cf.checksum_fold_partial(*args[:6])
    fin_err = int((cf.checksum_fold_finalize(slots, tags, next_id, etags)
                   - cf.checksum_fold_finalize_plain(slots, tags, next_id, etags)).abs().max())
    max_err = max(max_err, fin_err)
    if max_err:
        raise SystemExit(f"chip_smoke: the split fold's halves differ from plain ({max_err})")
    out.update(
        max_abs_err=max_err, tolerance="bit-exact (0)",
        one_call_ms=time_ms(lambda: cf.checksum_fold(*args), SIZES["kernel_reps"]),
        one_call_back_to_back_ms=run_ms(lambda: cf.checksum_fold(*args), SIZES["kernel_reps"]),
        partial_ms=time_ms(lambda: cf.checksum_fold_partial(*args[:6]), SIZES["kernel_reps"]),
        partial_back_to_back_ms=run_ms(lambda: cf.checksum_fold_partial(*args[:6]),
                                       SIZES["kernel_reps"]),
        partial_plain_ms=time_ms(lambda: cf.checksum_fold_partial_plain(*args[:6]),
                                 SIZES["kernel_reps"]),
        finalize_ms=time_ms(lambda: cf.checksum_fold_finalize(slots, tags, next_id, etags),
                            SIZES["kernel_reps"]),
        finalize_back_to_back_ms=run_ms(
            lambda: cf.checksum_fold_finalize(slots, tags, next_id, etags),
            SIZES["kernel_reps"]),
        finalize_plain_ms=time_ms(
            lambda: cf.checksum_fold_finalize_plain(slots, tags, next_id, etags),
            SIZES["kernel_reps"]),
        **split_bound(args, 1))
    return out


def twins_on_card(card: str) -> dict:
    """Part (e): two example twins as subprocesses with no platform set:
    both must run on the card and say so."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("BGT_PLATFORM", "JAX_PLATFORMS", "RANK", "WORLD_SIZE")}
    out = {"card": card}
    for name, args in (("box_game_synctest", ["--frames", "60", "--check-distance", "3"]),
                       ("crowd_multichip", ["--per-team", "1024", "--frames", "8"])):
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, str(HERE / "examples_torch" / f"{name}.py"),
                              *args], capture_output=True, text=True, env=env,
                             timeout=SIZES["shard_twin_timeout_s"], cwd=HERE)
        first = res.stdout.splitlines()[0] if res.stdout else ""
        if res.returncode != 0 or "cuda" not in first:
            raise SystemExit(f"chip_smoke: twin {name}: rc {res.returncode}:\n"
                             f"{res.stdout[-1500:]}\n{res.stderr[-1500:]}")
        out[name] = {"seconds": time.perf_counter() - t0, "first_line": first,
                     "last_line": res.stdout.splitlines()[-1]}
    return out


def phase_sharded(dev, card: str) -> dict:
    """Phase 18: the lobby axis (a, b), the entity mesh (c), the split
    fold (d) and the twins (e).  Returns the fold launches of the driven
    paths (the lobby waves' one-call folds, the entity mesh's partial and
    finalize) and the split pass's measurements."""
    import torch.distributed as dist

    from bevy_ggrs_tpu_torch.ops import checksum_fold as cf

    t0 = time.perf_counter()
    cf.launches = cf.partial_launches = cf.finalize_launches = 0
    a = sharded_waves(dev, card)
    emit("sharded_waves", **a)
    b = sharded_runner(dev, card)
    emit("sharded_runner", **b)
    lobby_launches = a["waves"]["exact"]["fold_launches"] + b["fold_launches"]
    c = entity_mesh(dev, card)
    emit("sharded_entity_mesh", **c)
    d = split_fold(dev, card)
    emit("sharded_split_fold", **d)
    e = twins_on_card(card)
    emit("sharded_twins", **e)
    if dist.is_initialized():
        dist.destroy_process_group()
    emit("sharded", seconds=time.perf_counter() - t0, card=card)
    return {"fold": lobby_launches, "partial": c["driver_partial_launches"],
            "finalize": c["driver_finalize_launches"], "split": d}


# -- phase surface: the public surface's tail ------------------------------------


def headline_app(dev):
    """stress_soa at the headline width built from top-level names only:
    ``App``, ``spawn_many``, ``DEFAULT_FPS`` and the model's step, with the
    columns ``stress_soa.make_app`` draws (seed 0)."""
    from bevy_ggrs_tpu_torch import DEFAULT_FPS, App, spawn_many
    from bevy_ggrs_tpu_torch.models import stress_soa

    n = SIZES["bench_entities"]
    app = App(num_players=2, capacity=n, fps=DEFAULT_FPS, input_shape=(),
              input_dtype=np.uint8, device=dev)
    for name in ("x", "y", "z", "vx", "vy", "vz"):
        app.rollback_component(name, (), torch.float32, checksum=True)
    app.set_step(stress_soa.step)
    rng = np.random.default_rng(0)
    cols = {c: rng.uniform(-40, 40, n).astype(np.float32) for c in ("x", "y", "z")}
    cols.update({c: rng.uniform(-5, 5, n).astype(np.float32) for c in ("vx", "vy", "vz")})
    app.set_setup(lambda world: spawn_many(app.reg, world, cols, count=n))
    return app


def surface_advance(dev, card: str) -> dict:
    """(a) ``ops.make_advance_fn`` over k frames of the 1M world (inputs
    uploaded with ``staging.commit``), each frame's state and checksum
    bit-equal to ``App.resim_fn``'s k-frame outputs, one fold launch per call; the last ``world_checksum`` equal
    to the plain fold's; ms per frame against ``resim_fn``'s, in turns."""
    from bevy_ggrs_tpu_torch import DEFAULT_FPS, checksum_to_int, ops, world_checksum
    from bevy_ggrs_tpu_torch.models import stress_soa
    from bevy_ggrs_tpu_torch.ops import checksum_fold as cf
    from bevy_ggrs_tpu_torch.utils import staging
    from bevy_ggrs_tpu_torch.utils.tree import tree_map

    n, k = SIZES["bench_entities"], SIZES["bench_k"]
    app = headline_app(dev)
    world = app.init_state()
    made = stress_soa.make_app(n_entities=n, device=dev)
    if checksum_to_int(world_checksum(app.reg, world)) != \
            checksum_to_int(world_checksum(made.reg, made.init_state())):
        raise SystemExit("chip_smoke: surface (a): the top-level build differs from "
                         "stress_soa.make_app's world")
    del made
    rng = np.random.default_rng(11)
    host_inputs = rng.integers(0, 16, (k, 2)).astype(np.uint8)
    inputs = staging.commit(host_inputs)  # the card by default; waits for the copy only
    if inputs.device != dev or not torch.equal(inputs.cpu(), torch.from_numpy(host_inputs)):
        raise SystemExit("chip_smoke: surface (a): staging.commit uploaded other values")
    status = on_device(np.zeros((k, 2), np.int8), dev)
    start = 100
    advance = ops.make_advance_fn(app.reg, app.step, DEFAULT_FPS)
    _, stacked, checks = app.resim_fn(world, inputs, status, start)
    sync(dev)
    cf.launches = 0
    w, frames_equal = world, 0
    for i in range(k):
        w, cs = advance(w, inputs[i], status[i], start + i + 1)
        if not (trees_equal(w, tree_map(lambda a, i=i: a[i], stacked))
                and torch.equal(cs, checks[i])):
            raise SystemExit(f"chip_smoke: surface (a): make_advance_fn's frame {i + 1} "
                             "differs from resim_fn's")
        frames_equal += 1
    sync(dev)
    launches = cf.launches
    if launches != k:
        raise SystemExit(f"chip_smoke: surface (a): {launches} fold launches for {k} "
                         "make_advance_fn calls")
    last = world_checksum(app.reg, w)
    args = fold_inputs(app.reg, tree_map(lambda a: a.unsqueeze(0), w))
    plain = cf.checksum_fold_plain(*args)[0, 0]
    if not (torch.equal(last, plain) and torch.equal(last, checks[-1])):
        raise SystemExit("chip_smoke: surface (a): the last world_checksum differs "
                         "from the plain fold's")

    def per_frame_ms(fn) -> float:
        start_ev = torch.cuda.Event(enable_timing=True)
        end_ev = torch.cuda.Event(enable_timing=True)
        sync(dev)
        start_ev.record()
        fn()
        end_ev.record()
        end_ev.synchronize()
        return start_ev.elapsed_time(end_ev) / k

    def run_advance():
        x = world
        for i in range(k):
            x, _ = advance(x, inputs[i], status[i], start + i + 1)

    def run_resim():
        app.resim_fn(world, inputs, status, start)

    run_advance()
    run_resim()
    adv_ms, res_ms = [], []
    for _ in range(SIZES["surface_advance_reps"]):
        adv_ms.append(per_frame_ms(run_advance))
        res_ms.append(per_frame_ms(run_resim))
    return {"card": card, "entities": n, "k": k, "frames_bit_equal": frames_equal,
            "fold_launches": launches, "last_checksum": hex(checksum_to_int(last)),
            "last_equals_plain_fold": True,
            "advance_ms_per_frame_median": statistics.median(adv_ms),
            "advance_ms_per_frame": adv_ms,
            "resim_ms_per_frame_median": statistics.median(res_ms),
            "resim_ms_per_frame": res_ms}


def surface_profile(dev, card: str) -> dict:
    """(b) ``GgrsRunner.profile`` around SyncTest ticks at stress_soa
    100,000: one ``*.pt.trace.json``, holding at least one ``fold_kernel``
    kernel and no more than the fold launches counted in the window."""
    import tempfile

    from bevy_ggrs_tpu_torch import GgrsRunner, SessionBuilder
    from bevy_ggrs_tpu_torch.models import stress_soa
    from bevy_ggrs_tpu_torch.ops import checksum_fold as cf

    if torch.autograd._profiler_enabled():
        raise SystemExit("chip_smoke: surface (b): a profiler is still open")
    n, ticks = SIZES["surface_profile_entities"], SIZES["surface_profile_ticks"]
    app = stress_soa.make_app(n_entities=n, device=dev)
    session = (SessionBuilder.for_app(app).with_check_distance(7)
               .start_synctest_session())
    holder = []

    def flipping(handles):
        phase = (holder[0].frame // 7) % 4
        return {h: np.uint8(1 << ((phase + h) % 4)) for h in handles}

    runner = GgrsRunner(app, session, read_inputs=flipping)
    holder.append(runner)
    for _ in range(3):  # warm-up outside the window
        runner.tick()
    with tempfile.TemporaryDirectory(prefix="surface_profile_") as logdir:
        sync(dev)
        cf.launches = 0
        t0 = time.perf_counter()
        with runner.profile(logdir) as r:
            for _ in range(ticks):
                r.tick()
        window_s = time.perf_counter() - t0
        launches = cf.launches
        traces = sorted(Path(logdir).glob("*.pt.trace.json"))
        if len(traces) != 1:
            raise SystemExit(f"chip_smoke: surface (b): {len(traces)} traces in the logdir")
        nbytes = traces[0].stat().st_size
        with open(traces[0]) as f:
            events = json.load(f).get("traceEvents", [])
    kernels = [e for e in events if e.get("cat") == "kernel"]
    folds = [e for e in kernels if "fold_kernel" in e.get("name", "")]
    runner.finish()
    if launches == 0 or not folds or len(folds) > launches:
        raise SystemExit(f"chip_smoke: surface (b): {len(folds)} fold_kernel events in "
                         f"the trace for {launches} fold launches")
    return {"card": card, "entities": n, "ticks": ticks, "trace_bytes": nbytes,
            "trace_events": len(events), "kernel_events": len(kernels),
            "fold_kernel_events": len(folds), "fold_launches": launches,
            "window_s": window_s}


def surface_readback(dev, card: str) -> dict:
    """(c) ``readback_stats`` and ``checksum_peek`` on phase p2p's default
    (pipelined) 1M pair: no forced read in the steady loop, harvests
    counted, every landed ref's peek equal to its ``to_int``."""
    from bevy_ggrs_tpu_torch.models import stress_soa
    from bevy_ggrs_tpu_torch.ops import checksum_fold as cf
    from bevy_ggrs_tpu_torch.snapshot.checksum import checksum_peek
    from bevy_ggrs_tpu_torch.snapshot.lazy import readback_stats

    n = SIZES["p2p_stress_entities"]
    net, runners, seen = channel_pair(lambda: stress_soa.make_app(n_entities=n, device=dev), 5)
    sync_sessions(runners, net)
    drive(runners, SIZES["surface_readback_warm"], net)
    sync(dev)
    own0 = [dataclasses.asdict(r.readbacks) for r in runners]
    resims0 = sum(r.resims for r in runners)
    before = readback_stats()
    cf.launches = 0
    drive(runners, SIZES["surface_readback_frames"], net)
    sync(dev)
    launches = cf.launches
    resims = sum(r.resims for r in runners) - resims0
    after = readback_stats()
    own = [{key: v - own0[i][key] for key, v in dataclasses.asdict(r.readbacks).items()}
           for i, r in enumerate(runners)]
    forced = after["forced"] - before["forced"]
    harvested = after["harvested"] - before["harvested"]
    refs = [ref for s in seen for ref in s.values()]
    landed = 0
    for ref in refs:
        v = checksum_peek(ref)
        if v is not None:
            landed += 1
            if v != ref.to_int():
                raise SystemExit("chip_smoke: surface (c): checksum_peek differs from to_int")
    for r in runners:
        r.finish()
    for ref in refs:
        v = checksum_peek(ref)
        if v is None or v != ref.to_int():
            raise SystemExit("chip_smoke: surface (c): a ref after finish() peeks "
                             f"{v}, not its value")
    if forced != 0 or harvested <= 0 or harvested != sum(o["harvested"] for o in own) \
            or launches != resims or any(desyncs(r) for r in runners):
        raise SystemExit(f"chip_smoke: surface (c): forced {forced}, harvested {harvested} "
                         f"(runners {own}), {launches} fold launches for {resims} resims")
    return {"card": card, "entities": n, "frames": SIZES["surface_readback_frames"],
            "forced": forced, "harvested": harvested,
            "blocked_seconds": after["blocked_seconds"] - before["blocked_seconds"],
            "runners_readbacks": own, "refs_peeked": len(refs), "landed_before_finish": landed,
            "fold_launches": launches, "resims": resims}


def e2e_twin():
    """``scripts/torch_e2e_p2p_check.py`` loaded as a module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "torch_e2e_p2p_check", HERE / "scripts" / "torch_e2e_p2p_check.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def surface_udp(dev, card: str) -> list:
    """(d) the UDP twin's logic in this process: box_game as in the
    script, then stress_soa 1M with peer 0's inputs flipping every frame; zero
    desyncs, equal confirmed checksums, rollbacks, one fold launch per
    resim; frames/s per peer beside phase p2p's channel pair."""
    from bevy_ggrs_tpu_torch.models import box_game, stress_soa
    from bevy_ggrs_tpu_torch.ops import checksum_fold as cf

    e2e = e2e_twin()
    n, ticks = SIZES["p2p_stress_entities"], SIZES["surface_udp_ticks"]

    holders = []

    def flipping(i):
        """Peer 0 alternates right and up every frame, peer 1 holds right:
        each frame peer 1 predicts is mispredicted."""
        holder = []
        holders.append(holder)
        return lambda handles: {h: np.uint8(8 if i == 1 or holder[0].frame % 2 == 0 else 1)
                                for h in handles}

    out = []
    for name, make_app, inputs, moved in (
            ("box_game", lambda: box_game.make_app(num_players=2, device=dev),
             e2e.random_inputs, "pos"),
            (f"stress_soa_{n}", lambda: stress_soa.make_app(n_entities=n, device=dev),
             flipping, "x")):
        runners = e2e.make_pair(make_app, inputs)
        for holder, r in zip(holders, runners):
            holder.append(r)
        holders.clear()
        seen = [record_confirmed(r) for r in runners]
        handshake_s = e2e.handshake(runners)
        sync(dev)
        frames0 = [r.frame for r in runners]
        resims0 = sum(r.resims for r in runners)
        cf.launches = 0
        t0 = time.perf_counter()
        e2e.play(runners, ticks)
        sync(dev)
        dt = time.perf_counter() - t0
        launches = cf.launches
        resims = sum(r.resims for r in runners) - resims0
        checked = e2e.check(runners, ticks, moved)
        agreed = agreed_checksums(seen)
        rollbacks = [r.rollbacks for r in runners]
        if launches != resims or len(agreed) < ticks // 2:
            raise SystemExit(f"chip_smoke: surface (d) {name}: {launches} fold launches "
                             f"for {resims} resims, {len(agreed)} confirmed frames agreed")
        out.append({"card": card, "pair": name, "transport": "udp 127.0.0.1",
                    "ticks_per_phase": ticks, "handshake_s": handshake_s, "seconds": dt,
                    "frames_per_s_per_peer": [(r.frame - f0) / dt
                                              for r, f0 in zip(runners, frames0)],
                    "channel_pair_frames_per_s_per_peer": P2P_RATES.get(name),
                    "final_frames": [r.frame for r in runners], "rollbacks": rollbacks,
                    "resimulated_frames": [r.rollback_frames for r in runners],
                    "stalls": [r.stalled_frames for r in runners],
                    "desyncs": checked["desyncs"], "confirmed_frames_agreed": len(agreed),
                    "fold_launches": launches, "resims": resims})
    return out


def surface_tool(card: str) -> dict:
    """(e) ``scripts/torch_parity_check.py`` as a subprocess: exit 0."""
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, str(HERE / "scripts" / "torch_parity_check.py")],
                         capture_output=True, text=True, cwd=HERE,
                         timeout=SIZES["surface_tool_timeout_s"])
    if res.returncode != 0 or "EXACT MATCH" not in res.stdout:
        raise SystemExit(f"chip_smoke: surface (e): torch_parity_check.py rc "
                         f"{res.returncode}:\n{res.stdout[-1500:]}\n{res.stderr[-1500:]}")
    return {"card": card, "rc": res.returncode, "seconds": time.perf_counter() - t0,
            "stdout": res.stdout.strip().splitlines()}


def phase_surface(dev, card: str) -> int:
    """Phase 19: the public surface's tail on the card, (a) to (e).
    Returns the fold launches of the driven paths."""
    t0 = time.perf_counter()
    a = surface_advance(dev, card)
    emit("surface_advance", **a)
    b = surface_profile(dev, card)
    emit("surface_profile", **b)
    c = surface_readback(dev, card)
    emit("surface_readback", **c)
    d = surface_udp(dev, card)
    for pair in d:
        emit("surface_udp", **pair)
    e = surface_tool(card)
    emit("surface_parity_tool", **e)
    launches = (a["fold_launches"] + b["fold_launches"] + c["fold_launches"]
                + sum(pair["fold_launches"] for pair in d))
    emit("surface", seconds=time.perf_counter() - t0, fold_launches=launches, card=card)
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    card = phase_device()
    dev = torch.device("cuda", 0)
    phase_build()
    kernel = phase_kernel(dev)
    phase_capture(dev)
    launches = phase_resim(dev)
    phase_parity(dev)
    phase_synctest(dev)
    by_path = {"resim": launches, "p2p": phase_p2p(dev),
               "telemetry": phase_telemetry(dev, card),
               "pipeline": phase_pipeline(dev, card),
               **phase_speculation(dev, card), "batched": phase_batched(dev, card),
               "megastep": phase_megastep(dev, card), "models": phase_models(dev, card),
               "spectator": phase_spectator(dev), "native": phase_native(dev),
               "fleet": phase_fleet(dev, card)}
    sharded = phase_sharded(dev, card)
    by_path["sharded"] = sharded["fold"]
    by_path["surface"] = phase_surface(dev, card)
    split = sharded["split"]
    halves = [{
        "name": f"checksum_fold_{half}",
        "route": "cuda",
        "source": "bevy_ggrs_tpu_torch/csrc/checksum_fold.cu",
        "replaces": "docs/pallas_negative_result.md:63",
        "launches": sharded[half],
        "launches_by_path": {"sharded": sharded[half]},
        "max_abs_err": split["max_abs_err"],
        "ms": split[f"{half}_ms"],
        "back_to_back_ms": split[f"{half}_back_to_back_ms"],
        "plain_ms": split[f"{half}_plain_ms"],
        "bound_ms": split[f"{half}_bound_ms"],
        "bound_by": split[f"{half}_bound_by"],
        "library_ms": None,
    } for half in ("partial", "finalize")]
    print(json.dumps({"kernels": [{
        "name": "checksum_fold",
        "route": "cuda",
        "source": "bevy_ggrs_tpu_torch/csrc/checksum_fold.cu",
        "replaces": "docs/pallas_negative_result.md:63",
        "launches": launches,
        "launches_by_path": by_path,
        "max_abs_err": kernel["max_abs_err"],
        "ms": kernel["ms"],
        "back_to_back_ms": kernel["back_to_back_ms"],
        "plain_ms": kernel["plain_ms"],
        "bound_ms": kernel["bound_ms"],
        "bound_by": kernel["bound_by"],
        "library_ms": None,
    }, *halves]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
