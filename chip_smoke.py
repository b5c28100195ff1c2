#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check it, phase by phase.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It imports the
port (``bevy_ggrs_tpu_torch``) and never JAX or the JAX package.  Each phase
prints one JSON line; any failure ends the script with a nonzero exit code
and no result.  The phases:

1. device   — the card's name and power limit (``nvidia-smi``); fails
               without CUDA;
2. build    — compiles ``csrc/checksum_fold.cu`` for sm_90a (timed);
3. kernel   — the checksum pass kernel against its plain torch version on
               the card, bit for bit: stress_soa 1M entities x k=8 with
               and without despawned rows, a frame slice of it, box_game /
               fixed_point worlds (L=2, int32), bool / bf16 / int64
               columns, ragged N (100,003) and a frame slice of it (an
               unaligned storage offset), 20 components, k=1 and k=17, a
               custom hash and no checksummed component; kernel and plain
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
               flipping inputs: box_game and fixed_point for 600 frames,
               stress_soa at 100k entities for 120 frames; zero mismatches;
8. result   — the kernels line, the card line, then
               ``{"ok": true, "device": {...}}`` as the last line.

Kernel launch counts are reset just before each driven path and read just
after it; a path that did not launch the kernel fails.  Launches made to
compare the kernel with its plain version are not counted.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
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
    "synctest_frames": 600,
    "synctest_stress_entities": 100_000,
    "synctest_stress_frames": 120,
    "parity_stress_entities": 4096,
    "kernel_reps": 25,
    "resim_reps": 5,
    "resim_iters": 10,
}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


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
        events[e.key[:80]] = {"per_call": e.count / calls, "ms_per_call": us / 1e3 / calls}
        device_us += us
    return {"events": events, "device_ms_per_call": device_us / 1e3 / calls,
            "host_ms_per_call": host_ms,
            "device_events_per_call": sum(v["per_call"] for v in events.values()),
            "htod_copies_per_call": sum(v["per_call"] for n, v in events.items()
                                        if "HtoD" in n),
            "profiler_saw_device": bool(events)}


def stacked_of(app, world, k: int):
    """A ``[k, ...]`` stack of worlds from a k-frame resim with fixed inputs."""
    inputs = np.full((k, app.num_players), 5, np.uint8)
    status = np.zeros((k, app.num_players), np.int8)
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
    from bevy_ggrs_tpu_torch.ops import checksum_fold

    t0 = time.perf_counter()
    lib = checksum_fold.build_library()
    checksum_fold._library()
    log = lib.with_suffix(".log")
    emit("build", seconds=time.perf_counter() - t0, library=lib.name,
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
    for name, mod in (("box_game", box_game), ("fixed_point", fixed_point)):
        app = mod.make_app(num_players=4, capacity=64, device=dev)
        cases[f"{name}_k8"] = (app.reg, stacked_of(app, app.init_state(), k))
    app, world = columns_app(n_small, {"flag": ((), torch.bool, None),
                                       "half": ((3,), torch.bfloat16, None),
                                       "big": ((2,), torch.int64, None)})
    cases["bool_bf16_int64"] = (app.reg, stacked_of(app, world, k))
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
    inputs = np.zeros((k, 2), np.uint8)
    status = np.zeros((k, 2), np.int8)
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
        _, _, checks = app.resim_fn(app.init_state(), inputs, status, 0)
        runs[d] = [checksum_to_int(c) for c in checks.cpu()]
    if runs[dev] != runs["cpu"]:
        raise SystemExit(f"chip_smoke: fixed_point checksums differ between "
                         f"{dev} and cpu: {runs[dev]} vs {runs['cpu']}")
    states = {}
    for d in (dev, "cpu"):
        app = stress_soa.make_app(n_entities=SIZES["parity_stress_entities"], device=d)
        inputs = np.zeros((8, 2), np.uint8)
        _, stacked, _ = app.resim_fn(app.init_state(), inputs, np.zeros((8, 2), np.int8), 0)
        states[d] = {c: v.cpu() for c, v in stacked.comps.items()}
    diff = max(float((states[dev][c] - states["cpu"][c]).abs().max()) for c in states["cpu"])
    if not diff <= 1e-4:
        raise SystemExit(f"chip_smoke: stress_soa on {dev} strays {diff} from cpu")
    emit("parity", fixed_point_frames=k, fixed_point_exact=True,
         fixed_point_last=hex(runs[dev][-1]), stress_soa_max_abs_diff=diff,
         stress_soa_tolerance=1e-4)


def synctest(app, frames: int, check_distance: int = 7) -> dict:
    """One SyncTest run through the runner; a mismatch raises."""
    from bevy_ggrs_tpu_torch import GgrsRunner, SessionBuilder
    from bevy_ggrs_tpu_torch.ops import checksum_fold as cf

    session = (SessionBuilder.for_app(app).with_check_distance(check_distance)
               .start_synctest_session())
    holder = []

    def read_inputs(handles):
        phase = (holder[0].frame // 7) % 4
        return {h: np.uint8(1 << ((phase + h) % 4)) for h in handles}

    runner = GgrsRunner(app, session, read_inputs=read_inputs)
    holder.append(runner)
    sync(app.device)
    cf.launches = 0
    t0 = time.perf_counter()
    for _ in range(frames):
        runner.tick()
    runner.finish()
    sync(app.device)
    dt = time.perf_counter() - t0
    if cf.launches == 0:
        raise SystemExit("chip_smoke: the SyncTest run never launched the fold")
    if runner.frame != frames or session.pending_comparisons() != 0:
        raise SystemExit("chip_smoke: SyncTest run ended short or uncompared")
    return {"frames": frames, "check_distance": check_distance,
            "frames_per_s": frames / dt, "seconds": dt, "rollbacks": runner.rollbacks,
            "resimulated_frames": runner.rollback_frames,
            "kernel_launches": cf.launches, "mismatches": 0,
            "final_checksum": hex(runner.checksum)}


def phase_synctest(dev) -> None:
    from bevy_ggrs_tpu_torch.models import box_game, fixed_point, stress_soa

    runs = {
        "box_game": synctest(box_game.make_app(device=dev), SIZES["synctest_frames"]),
        "fixed_point": synctest(fixed_point.make_app(device=dev),
                                SIZES["synctest_frames"]),
        "stress_soa_100k": synctest(
            stress_soa.make_app(n_entities=SIZES["synctest_stress_entities"], device=dev),
            SIZES["synctest_stress_frames"]),
    }
    for name, r in runs.items():
        emit("synctest", model=name, **r)


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
    print(json.dumps({"kernels": [{
        "name": "checksum_fold",
        "route": "cuda",
        "source": "bevy_ggrs_tpu_torch/csrc/checksum_fold.cu",
        "replaces": "docs/pallas_negative_result.md:63",
        "launches": launches,
        "max_abs_err": kernel["max_abs_err"],
        "ms": kernel["ms"],
        "back_to_back_ms": kernel["back_to_back_ms"],
        "plain_ms": kernel["plain_ms"],
        "bound_ms": kernel["bound_ms"],
        "bound_by": kernel["bound_by"],
        "library_ms": None,
    }]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
