#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check it, phase by phase.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It imports the
port (``bevy_ggrs_tpu_torch``) and never JAX or the JAX package.  Each phase
prints one JSON line; any failure ends the script with a nonzero exit code
and no result.  The phases:

1. device   — the card's name and power limit (``nvidia-smi``); fails
               without CUDA;
2. build    — compiles ``csrc/checksum_fold.cu`` for sm_90a (timed);
3. kernel   — the checksum fold kernel against its plain torch version on
               the card, bit for bit: stress_soa 1M entities x k=8 with
               despawned rows, box_game / fixed_point worlds (L=2, int32),
               and bool / bf16 / int64 columns; kernel and plain times;
4. resim    — ``App.resim_fn`` on stress_soa at 1M entities x k=8 (the
               bench path), states and checksums: resim frames/s (median
               and spread of 5 reps x 10 calls), the checksum pass's share;
5. parity   — fixed_point's scripted 12-frame resim on the card and on CPU
               torch: the 64-bit checksums must match frame by frame; a
               4096-entity stress_soa resim is held to the CPU's states;
6. synctest — ``GgrsRunner`` + ``SyncTestSession`` at check_distance 7 with
               flipping inputs: box_game and fixed_point for 600 frames,
               stress_soa at 100k entities for 120 frames; zero mismatches;
7. result   — the kernels line, the card line, then
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

# H100 SXM data-sheet peaks (dense, 700 W): HBM3 bandwidth, and the
# non-tensor 32-bit rate used for the fold's integer operations.
HBM_BYTES_PER_S = 3.35e12
SCALAR32_OPS_PER_S = 67e12

SIZES = {
    "bench_entities": 1_000_000,
    "bench_k": 8,
    "dtype_entities": 100_000,
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


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def time_ms(fn, reps: int) -> float:
    """Median milliseconds of ``fn()`` over ``reps`` runs, timed with CUDA
    events around each run after two warm-up runs."""
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


# -- the fold's inputs and its bound --------------------------------------------


def fold_inputs(reg, stacked):
    """The checksum_fold arguments for every checksummed component."""
    from bevy_ggrs_tpu_torch.snapshot.checksum import fold_inputs as inputs

    return inputs(reg, stacked, [n for n, s in reg.components.items() if s.checksum])


def fold_bound(args) -> dict:
    """Least time for the fold on these inputs: every byte it needs read once
    (a row's pending byte only if alive, its has byte only if active, its
    lanes and id only if kept) and its output written once, over HBM
    bandwidth; and its 32-bit integer operations over the scalar rate."""
    lanes, has, ids, alive, pending, _ = args
    k, n = ids.shape
    active = alive & ~pending
    nbytes = k * n + int(alive.sum()) + k * len(lanes) * 2 * 4
    ops = 0
    any_keep = torch.zeros_like(alive)
    for ln, hs in zip(lanes, has):
        keep = active & hs
        n_keep = int(keep.sum())
        n_lanes = ln.shape[2]
        nbytes += int(active.sum()) + n_keep * n_lanes * 4
        # per seed: (L + 1) mix32 rounds of 6 ops, 2 fmix32 of 8, 2 more
        ops += n_keep * 2 * (6 * (n_lanes + 1) + 16 + 2)
        any_keep |= keep
    nbytes += int(any_keep.sum()) * 4
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / SCALAR32_OPS_PER_S * 1e3
    return {"bytes": nbytes, "ops": ops, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


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
         ptxas=log.read_text().strip().splitlines()[-4:] if log.exists() else [])


def phase_kernel(dev) -> dict:
    """Kernel against plain, bit for bit, on every case; times at the bench
    shape (the main path's)."""
    from bevy_ggrs_tpu_torch import App
    from bevy_ggrs_tpu_torch.models import box_game, fixed_point, stress_soa
    from bevy_ggrs_tpu_torch.ops import checksum_fold as cf
    from bevy_ggrs_tpu_torch.snapshot import despawn_where, spawn_many

    n_bench, k = SIZES["bench_entities"], SIZES["bench_k"]
    n_small = SIZES["dtype_entities"]
    gen = torch.Generator(device="cpu").manual_seed(11)

    def with_despawns(app, w, frac):
        kill = (torch.rand(app.reg.capacity, generator=gen) < frac).to(dev)
        return despawn_where(app.reg, w, kill, 0)

    cases = {}
    bench_app = stress_soa.make_app(n_entities=n_bench, device=dev)
    bench_world = bench_app.init_state()
    cases["stress_soa_1M_k8"] = (bench_app.reg, stacked_of(bench_app, bench_world, k))
    cases["stress_soa_1M_k8_despawned"] = (
        bench_app.reg,
        stacked_of(bench_app, with_despawns(bench_app, bench_world, 0.1), k),
    )
    for name, mod in (("box_game", box_game), ("fixed_point", fixed_point)):
        app = mod.make_app(num_players=4, capacity=64, device=dev)
        cases[f"{name}_k8"] = (app.reg, stacked_of(app, app.init_state(), k))
    dt_app = App(capacity=n_small, device=dev)
    rng = np.random.default_rng(3)
    cols = {
        "flag": rng.integers(0, 2, n_small).astype(bool),
        "half": torch.from_numpy(rng.standard_normal((n_small, 3)).astype(np.float32))
        .to(torch.bfloat16),
        "big": rng.integers(-2**62, 2**62, (n_small, 2), dtype=np.int64),
    }
    dt_app.rollback_component("flag", (), torch.bool, checksum=True)
    dt_app.rollback_component("half", (3,), torch.bfloat16, checksum=True)
    dt_app.rollback_component("big", (2,), torch.int64, checksum=True)
    dt_app.set_step(lambda w, ctx: w)
    dt_world = spawn_many(dt_app.reg, dt_app.init_state(), cols, n_small - 100)
    cases["bool_bf16_int64"] = (
        dt_app.reg, stacked_of(dt_app, with_despawns(dt_app, dt_world, 0.2), k))

    max_err = 0
    checked = {}
    cf.launches = 0
    for name, (reg, stacked) in cases.items():
        args = fold_inputs(reg, stacked)
        got = cf.checksum_fold(*args)
        want = cf.checksum_fold_plain(*args)
        sync(dev)
        err = int((got - want).abs().max())
        max_err = max(max_err, err)
        checked[name] = {"shape": list(args[2].shape), "comps": len(args[0]),
                         "max_abs_err": err}
        if err != 0:
            raise SystemExit(f"chip_smoke: checksum_fold disagrees with its plain "
                             f"version on {name} (max abs err {err})")
    bench_args = fold_inputs(bench_app.reg, cases["stress_soa_1M_k8"][1])
    ms = time_ms(lambda: cf.checksum_fold(*bench_args), SIZES["kernel_reps"])
    plain_ms = time_ms(lambda: cf.checksum_fold_plain(*bench_args), SIZES["kernel_reps"])
    bound = fold_bound(bench_args)
    result = {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms, **bound}
    emit("kernel", name="checksum_fold", tolerance="bit-exact (0)", cases=checked,
         at="stress_soa 1M x k=8, 6 f32 columns", **result,
         bound_us=bound["bound_ms"] * 1e3, kernel_launches=cf.launches,
         achieved_gb_s=bound["bytes"] / (ms * 1e-3) / 1e9,
         roofline_share=bound["bound_ms"] / ms)
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
