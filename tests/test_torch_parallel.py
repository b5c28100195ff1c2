"""The port's entity and branch meshes (``bevy_ggrs_tpu_torch/parallel``),
held against its one-device path and the JAX package's sharded results.

Mirrors ``tests/test_parallel.py``, ``tests/test_sharded_driver.py`` and
``tests/test_multihost.py``.  The JAX tests shard over eight virtual CPU
devices in one process; torch has no single-controller global array, so
here the mesh's ranks are real ``torch.distributed`` processes on gloo,
with real collectives.  Each mesh shape's checks run in ONE spawn of its
ranks, which rendezvous through a ``FileStore`` in ``tmp_path`` (no TCP
port: the suite runs under ``-n 6``); every rank gets a timeout, and all
are killed when one fails or times out.

The split checksum fold's plain version (partial pass, summed slots,
finalize) is held against the one-call plain fold in process.

Run one rank by hand: ``python tests/test_torch_parallel.py <scenario>
<rank> <world> <store path>``.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

RANK_TIMEOUT_S = 120


# -- the ranks ------------------------------------------------------------------


def _full(tree):
    from torch.distributed.tensor import DTensor

    from bevy_ggrs_tpu_torch.utils.tree import tree_map

    return tree_map(lambda a: a.full_tensor() if isinstance(a, DTensor) else a, tree)


def _trees_equal(a, b) -> bool:
    from bevy_ggrs_tpu_torch.utils.tree import tree_flatten

    la, lb = tree_flatten(_full(a)), tree_flatten(_full(b))
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


def _placements(x) -> list:
    return [repr(p) for p in x.placements]


def _stress_driver(mesh, shard: bool, ticks: int = 24, n: int = 512):
    """A SyncTest driver over a stress world; sharded, the runner's resim
    functions are the mesh's (counted) and its world starts sharded."""
    from bevy_ggrs_tpu_torch import GgrsRunner, SyncTestSession
    from bevy_ggrs_tpu_torch.models import stress
    from bevy_ggrs_tpu_torch.parallel import make_sharded_resim_fn, shard_world

    app = stress.make_app(n, capacity=n, device="cpu")
    session = SyncTestSession(num_players=2, input_shape=(), input_dtype=np.uint8,
                              check_distance=3, compare_interval=1)
    calls = [0]
    kwargs = {}
    if shard:
        sharded = make_sharded_resim_fn(app, mesh)

        def counted(*args):
            calls[0] += 1
            return sharded(*args)

        # the runner's unpacked path calls resim_fn or, donating,
        # resim_fn_donated: both go through the mesh
        app.__dict__["resim_fn"] = counted
        app.__dict__["resim_fn_donated"] = counted
        kwargs["initial_state"] = shard_world(app, mesh, app.init_state())
    rng = np.random.default_rng(7)
    mismatches = []
    runner = GgrsRunner(app, session, packed=False,
                        read_inputs=lambda hs: {h: np.uint8(rng.integers(0, 8)) for h in hs},
                        on_mismatch=mismatches.append, **kwargs)
    sums = []
    for _ in range(ticks):
        runner.tick()
        sums.append(runner.checksum)
    runner.finish()
    return sums, mismatches, runner, calls[0]


def _scenario_data4(rank: int, world: int) -> dict:
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.experimental import implicit_replication

    from bevy_ggrs_tpu_torch.models import particles
    from bevy_ggrs_tpu_torch.parallel import make_mesh, make_sharded_resim_fn, shard_world
    from bevy_ggrs_tpu_torch.utils import threefry

    mesh = make_mesh(n_data=4, n_spec=1, devices="cpu")
    out = {"mesh_shape": list(mesh.mesh.shape), "dims": list(mesh.mesh_dim_names)}

    # the experimental API the sharded call runs under, and the shift
    # operators it cannot use: pinned so a torch upgrade shows up here
    x = DTensor.from_local(torch.tensor([123456789, 5]), mesh["data"], [Replicate()],
                           run_check=False)
    with implicit_replication():
        out["implicit_replication_add"] = (x + torch.tensor([1, 1])).to_local().tolist()
    out["bitwise_shifts"] = [torch.bitwise_left_shift(x, 13).to_local().tolist(),
                             torch.bitwise_right_shift(x, 3).to_local().tolist()]
    out["helper_rotl"] = threefry._rotl(x, 13).to_local().tolist()

    app = particles.make_app(rate=8, ttl=16, capacity=256, device="cpu")
    w = app.init_state()
    k = 4
    inputs = np.zeros((k, 2), np.uint8)
    status = np.zeros((k, 2), np.int8)
    f0, s0, c0 = app.resim_fn(w, inputs, status, 0)
    f1, s1, c1 = make_sharded_resim_fn(app, mesh)(w, inputs, status, 0)
    out["particles_final"] = _trees_equal(f1, f0)
    out["particles_stack"] = _trees_equal(s1, s0)
    out["particles_checks"] = torch.equal(c1, c0)
    out["particles_live"] = int(s0.alive[-1].sum())
    out["final_pos_placements"] = _placements(f1.comps["pos"])
    out["stack_pos_placements"] = _placements(s1.comps["pos"])
    placed = shard_world(app, mesh, w)
    out["shard_local_rows"] = placed.comps["pos"].to_local().shape[0]
    out["shard_is_dtensor"] = isinstance(placed.comps["pos"], DTensor)
    out["resource_placements"] = _placements(placed.res["rng_counter"])

    ref, mm_ref, _r, _c = _stress_driver(mesh, shard=False)
    got, mm, runner, calls = _stress_driver(mesh, shard=True)
    col = runner.world.comps["pos"]
    out.update(
        driver_equal=got == ref, driver_mismatches=len(mm) + len(mm_ref),
        driver_sharded_calls=calls, driver_ticks=len(got),
        driver_world_dtensor=isinstance(col, DTensor),
        driver_world_placements=_placements(col) if isinstance(col, DTensor) else [],
        driver_world_ranks=col.device_mesh.size() if isinstance(col, DTensor) else 0,
        shard0=repr(Shard(0)),
    )
    return out


def _scenario_data2_spec2(rank: int, world: int) -> dict:
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from test_torch_canonical_speculation import B, K, make_canonical_app

    from bevy_ggrs_tpu_torch.models import box_game
    from bevy_ggrs_tpu_torch.parallel import (
        make_mesh,
        make_sharded_canonical_fn,
        make_sharded_speculate_fn,
    )

    mesh = make_mesh(n_data=2, n_spec=2, devices="cpu")
    out = {"mesh": mesh.mesh.tolist()}
    app = box_game.make_app(num_players=2, capacity=16, device="cpu")
    world = app.init_state()
    k, m = 4, 4
    branches = np.zeros((m, k, 2), np.uint8)
    for b in range(m):
        branches[b, :, 1] = b
    statuses = np.zeros((m, k, 2), np.int8)
    f0, s0, c0 = app.speculate_fn(world, branches, statuses, 0)
    f1, s1, c1 = make_sharded_speculate_fn(app, mesh)(world, branches, statuses, 0)
    out["spec_checks"] = torch.equal(c1.full_tensor(), c0)
    out["spec_final"] = _trees_equal(f1, f0)
    out["spec_stack"] = _trees_equal(s1, s0)
    out["spec_pos_placements"] = _placements(f1.comps["pos"])
    out["spec_local_branches"] = c1.to_local().shape[0]

    capp = make_canonical_app()
    cw = capp.init_state()
    rng = np.random.default_rng(3)
    ib = rng.integers(0, 3, (B, K, 2)).astype(np.uint8)
    sb = np.zeros((B, K, 2), np.int8)
    n_real = np.array([K, K - 3, 1, K], np.int32)
    g0 = capp.branched_fn(cw, ib, sb, 0, n_real)
    g1 = make_sharded_canonical_fn(capp, mesh)(cw, ib, sb, 0, n_real)
    out["canonical_checks"] = torch.equal(g1[2].full_tensor(), g0[2])
    out["canonical_final"] = _trees_equal(g1[0], g0[0])
    out["canonical_stack"] = _trees_equal(g1[1], g0[1])
    return out


def _fixed_point_resim(resim_fn):
    from bevy_ggrs_tpu_torch.models import fixed_point
    from bevy_ggrs_tpu_torch.snapshot.checksum import checksum_to_int

    app = fixed_point.make_app(capacity=16, device="cpu")
    rng = np.random.default_rng(7)
    inputs = rng.integers(0, 16, (8, 2)).astype(np.uint8)
    status = np.zeros((8, 2), np.int8)
    fn = resim_fn(app) if resim_fn is not None else app.resim_fn
    _, _, checks = fn(app.init_state(), inputs, status, 0)
    return [checksum_to_int(c) for c in checks]


def _scenario_multihost(rank: int, world: int) -> dict:
    from bevy_ggrs_tpu_torch.parallel import make_sharded_resim_fn, multihost

    # the group exists (FileStore): initialize is then a no-op, as in JAX
    multihost.initialize("127.0.0.1:1", num_processes=world, process_id=rank)
    mesh = multihost.make_multihost_mesh(n_spec=2, devices="cpu")
    sharded = _fixed_point_resim(lambda app: make_sharded_resim_fn(app, mesh))
    return {
        "mesh": mesh.mesh.tolist(),
        "process_count": multihost.process_count(),
        "is_primary": multihost.is_primary(),
        "sharded": sharded,
        "single": _fixed_point_resim(None),
    }


_SCENARIOS = {
    "data4": _scenario_data4,
    "data2_spec2": _scenario_data2_spec2,
    "multihost": _scenario_multihost,
}


def _rank_main(scenario: str, rank: int, world: int, store: str) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    try:
        result = _SCENARIOS[scenario](rank, world)
        print("RESULT " + json.dumps(result), flush=True)
    finally:
        dist.destroy_process_group()


# -- the tests ------------------------------------------------------------------


def spawn_ranks(scenario: str, world: int, tmp_path, timeout: float = RANK_TIMEOUT_S):
    """Run ``scenario`` on ``world`` gloo ranks (this file as a script);
    returns each rank's result.  Kills every rank on a failure or when
    the timeout runs out."""
    store = str(tmp_path / f"store_{scenario}")
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), scenario, str(r), str(world), store],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=REPO)
        for r in range(world)]
    outs = [""] * world
    deadline = time.monotonic() + timeout
    try:
        for r, p in enumerate(procs):
            outs[r], _ = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pytest.fail(f"{scenario}: a rank ran past {timeout} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    results = []
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"{scenario} rank {r} failed:\n{out[-4000:]}"
        line = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
        assert line, f"{scenario} rank {r} printed no result:\n{out[-4000:]}"
        results.append(json.loads(line[-1][len("RESULT "):]))
    return results


def test_data_mesh_of_four_ranks(tmp_path):
    """data = 4: the particles resim (spawns, Threefry draws, despawns) and
    a 24-tick SyncTest driver over a 512-entity stress world give the
    one-device states and checksums bit for bit on every rank, and the
    driver really ran the mesh's function over a world split four ways."""
    results = spawn_ranks("data4", 4, tmp_path)
    for r in results:
        assert r["mesh_shape"] == [4, 1] and r["dims"] == ["data", "spec"]
        assert r["implicit_replication_add"] == [123456790, 6]
        assert r["bitwise_shifts"] == [[123456789 << 13, 5 << 13], [123456789 >> 3, 0]]
        rotl = [((v << 13) | (v >> 19)) & 0xFFFFFFFF for v in (123456789, 5)]
        assert r["helper_rotl"] == rotl
        assert r["particles_final"] and r["particles_stack"] and r["particles_checks"]
        assert r["particles_live"] > 0
        assert r["final_pos_placements"] == ["Shard(dim=0)", "Replicate()"]
        assert r["stack_pos_placements"] == ["Shard(dim=1)", "Replicate()"]
        assert r["shard_is_dtensor"] and r["shard_local_rows"] == 64
        assert r["resource_placements"] == ["Replicate()", "Replicate()"]
        assert r["driver_equal"], "sharded driver diverged from unsharded"
        assert r["driver_mismatches"] == 0
        assert r["driver_sharded_calls"] > 0 and r["driver_ticks"] == 24
        assert r["driver_world_dtensor"]
        assert r["driver_world_placements"] == ["Shard(dim=0)", "Replicate()"]
        assert r["driver_world_ranks"] == 4


def test_data_by_spec_mesh(tmp_path):
    """data = 2 x spec = 2: box_game speculation and the canonical
    branched program equal the one-device ``speculate_fn`` and
    ``branched_fn``, each spec rank holding its block of branches."""
    results = spawn_ranks("data2_spec2", 4, tmp_path)
    for r in results:
        assert r["mesh"] == [[0, 1], [2, 3]]
        assert r["spec_checks"] and r["spec_final"] and r["spec_stack"]
        assert r["spec_pos_placements"] == ["Shard(dim=1)", "Shard(dim=0)"]
        assert r["spec_local_branches"] == 2
        assert r["canonical_checks"] and r["canonical_final"] and r["canonical_stack"]


def test_multihost_mesh_matches_single_device_and_jax(tmp_path):
    """A ``make_multihost_mesh(n_spec=2)`` run of ``fixed_point`` over four
    ranks: every rank's checksums equal the one-device run and the JAX
    package's sharded result on its eight virtual devices (4 x 2)."""
    results = spawn_ranks("multihost", 4, tmp_path)
    # process-major ranks, "spec" across processes: rank j * 2 + i at (i, j)
    assert all(r["mesh"] == [[0, 2], [1, 3]] for r in results)
    assert [r["is_primary"] for r in results] == [True, False, False, False]
    assert all(r["process_count"] == 4 for r in results)
    sums = [r["sharded"] for r in results]
    assert all(s == sums[0] for s in sums), "ranks disagree"
    assert sums[0] == results[0]["single"], "sharded differs from one device"

    from bevy_ggrs_tpu.models import fixed_point as jfp
    from bevy_ggrs_tpu.parallel import make_mesh as jmake_mesh
    from bevy_ggrs_tpu.parallel import make_sharded_resim_fn as jsharded
    from bevy_ggrs_tpu.snapshot.checksum import checksum_to_int as jint

    japp = jfp.make_app(capacity=16)
    rng = np.random.default_rng(7)
    inputs = rng.integers(0, 16, (8, 2)).astype(np.uint8)
    status = np.zeros((8, 2), np.int8)
    _, _, checks = jsharded(japp, jmake_mesh(n_data=4, n_spec=2))(
        japp.init_state(), inputs, status, 0)
    assert sums[0] == [jint(c) for c in np.asarray(checks)], "port differs from JAX"


def test_world_sharding_placements_in_process(tmp_path):
    """``make_mesh`` in a process with no group starts a one-rank gloo
    group on a HashStore (no port); ``world_sharding`` splits the capacity
    axis and replicates the rest, and a one-rank sharded resim equals the
    plain one."""
    code = (
        "import numpy as np, torch\n"
        "from bevy_ggrs_tpu_torch.models import particles\n"
        "from bevy_ggrs_tpu_torch.parallel import make_mesh, world_sharding, "
        "make_sharded_resim_fn\n"
        "import torch.distributed as dist\n"
        "mesh = make_mesh(devices='cpu')\n"
        "assert dist.get_world_size() == 1 and dist.get_backend() == 'gloo'\n"
        "app = particles.make_app(rate=4, ttl=8, capacity=64, device='cpu')\n"
        "w = app.init_state()\n"
        "pl = world_sharding(app.reg, mesh, w)\n"
        "assert [repr(p) for p in pl.comps['pos']] == ['Shard(dim=0)', 'Replicate()']\n"
        "assert [repr(p) for p in pl.res['rng_counter']] == ['Replicate()', 'Replicate()']\n"
        "i = np.zeros((3, 2), np.uint8); s = np.zeros((3, 2), np.int8)\n"
        "a = app.resim_fn(w, i, s, 0)[2]; b = make_sharded_resim_fn(app, mesh)(w, i, s, 0)[2]\n"
        "assert torch.equal(a, b)\n"
        "print('OK')\n")
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=REPO, timeout=RANK_TIMEOUT_S)
    assert res.returncode == 0 and "OK" in res.stdout, res.stdout + res.stderr


def test_port_import_leaves_dtensor_unloaded():
    """The package's top level does not import ``parallel``, and neither
    does ``parallel`` import DTensor's machinery until it is called."""
    code = ("import sys, bevy_ggrs_tpu_torch, bevy_ggrs_tpu_torch.parallel\n"
            "print('torch.distributed.tensor' in sys.modules)\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env={**os.environ, "PYTHONPATH": REPO}, cwd=REPO,
                         timeout=RANK_TIMEOUT_S)
    assert res.returncode == 0 and res.stdout.strip() == "False", res.stdout + res.stderr


def test_make_mesh_refuses_a_card_without_one():
    """The entity mesh defaults to CUDA and raises without a card; it never
    switches to gloo on its own."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from bevy_ggrs_tpu_torch.parallel import make_lobby_mesh, make_mesh

    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_lobby_mesh()


@pytest.mark.parametrize("blocks", [1, 2, 4])
@pytest.mark.parametrize("model", ["particles", "stress"])
def test_split_fold_plain_equals_one_call(blocks, model):
    """The split pass's plain version: each row block's partial slots,
    summed mod 2**32, finalized, equal the one-call plain fold bit for bit
    (checksums and every component part)."""
    from bevy_ggrs_tpu_torch.models import particles, stress
    from bevy_ggrs_tpu_torch.ops.checksum_fold import (
        MASK32,
        checksum_fold,
        checksum_fold_finalize,
        checksum_fold_partial,
    )
    from bevy_ggrs_tpu_torch.snapshot.checksum import fold_inputs

    if model == "particles":
        app = particles.make_app(rate=8, ttl=16, capacity=256, device="cpu")
    else:
        app = stress.make_app(200, capacity=256, device="cpu")
    k = 5
    inputs = np.random.default_rng(blocks).integers(0, 16, (k, 2)).astype(np.uint8)
    _, stacked, _ = app.resim_fn(app.init_state(), inputs, np.zeros((k, 2), np.int8), 0)
    names = [n for n, s in app.reg.components.items() if s.checksum]
    lanes, has, ids, alive, pending, tags, next_id, etags = fold_inputs(app.reg, stacked,
                                                                       names)
    whole = checksum_fold(lanes, has, ids, alive, pending, tags, next_id, etags)
    n = ids.shape[1]
    bounds = [n * j // blocks for j in range(blocks + 1)]
    slots = torch.zeros((k, 2 * len(names) + 1), dtype=torch.int64)
    for lo, hi in zip(bounds, bounds[1:]):
        slots += checksum_fold_partial(
            [ln[:, lo:hi].contiguous() for ln in lanes],
            [h[:, lo:hi].contiguous() for h in has],
            ids[:, lo:hi].contiguous(), alive[:, lo:hi].contiguous(),
            pending[:, lo:hi].contiguous(), tags)
    split = checksum_fold_finalize(slots & MASK32, tags, next_id, etags)
    assert torch.equal(split, whole)


if __name__ == "__main__":
    _rank_main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
