"""The hierarchy on the port, held against the JAX package.

Mirrors ``tests/test_hierarchy.py`` (all three tests): 3-level parent
chains survive continuous SyncTest rollback, a child despawn rolls back
cleanly, and a recursive root despawn takes the whole subtree; each runs
in both packages with equal checksum streams.  Besides, the port's
``despawn_recursive`` (pointer jumping in ``ceil(log2 capacity)`` rounds)
is held bit for bit to the JAX package's ``lax.while_loop`` fixpoint on
seeded worlds: chains broken by a dead link or a missing parent, cycles,
parents out of range, negative and out-of-range slots, a world that is
full and a single chain as long as the capacity.  Under ``torch.func.vmap``
over a lane axis it gives every lane's own result, which it could not if
it read anything back to the host."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bevy_ggrs_tpu as J
import bevy_ggrs_tpu.snapshot as JS
import bevy_ggrs_tpu_torch as T
import bevy_ggrs_tpu_torch.snapshot as TS
from bevy_ggrs_tpu_torch.convert import to_numpy, world_from_numpy
from bevy_ggrs_tpu_torch.utils.tree import tree_flatten, tree_map, tree_unflatten

PARENT = TS.Registry.PARENT


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes, and
    idle OpenMP threads spinning here would take cores from the
    wall-clock-driven games of other files."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def make_chain_app(pkg, levels=3, chains=4, despawn_leaf_at=None, despawn_root_at=None):
    S = JS if pkg is J else TS
    xp = jnp if pkg is J else torch
    kw = {} if pkg is J else {"device": "cpu"}
    app = pkg.App(num_players=1, capacity=32, input_shape=(), input_dtype=np.uint8, **kw)
    app.register_hierarchy()
    app.rollback_component("depth", (), xp.int32, checksum=True)
    app.rollback_component("age", (), xp.int32, checksum=True)
    roots = []

    def step(world, ctx):
        m = S.active_mask(world) & world.has["age"]
        world = dataclasses.replace(world, comps={
            **world.comps, "age": xp.where(m, world.comps["age"] + 1, world.comps["age"])})
        if despawn_leaf_at is not None:
            kill = m & (ctx.frame == despawn_leaf_at) & (world.comps["depth"] == levels - 1)
            world = S.despawn_where(app.reg, world, kill, ctx.frame)
        if despawn_root_at is not None:
            if pkg is J:
                world = jax.lax.cond(
                    ctx.frame == despawn_root_at,
                    lambda w: S.despawn_recursive(app.reg, w, roots[0], ctx.frame),
                    lambda w: w, world)
            elif ctx.frame == despawn_root_at:
                world = S.despawn_recursive(app.reg, world, roots[0], ctx.frame)
        return world

    def setup(world):
        for _c in range(chains):
            parent = -1
            for d in range(levels):
                world, slot = S.spawn(app.reg, world,
                                      {PARENT: parent, "depth": d, "age": 0})
                if d == 0:
                    roots.append(int(slot))
                parent = int(slot)
        return world

    app.set_step(step)
    app.set_setup(setup)
    return app


def run(pkg, app, ticks, check_distance=3):
    session = pkg.SyncTestSession(num_players=1, input_shape=(), input_dtype=np.uint8,
                                  check_distance=check_distance)
    mismatches = []
    kw = {"pipeline": False} if pkg is J else {}
    runner = pkg.GgrsRunner(app, session, on_mismatch=mismatches.append, **kw)
    stream = []
    for _ in range(ticks):
        runner.tick()
        stream.append(runner.checksum)
    return runner, mismatches, stream


def both(ticks=20, **kw):
    port = run(T, make_chain_app(T, **kw), ticks)
    jax_side = run(J, make_chain_app(J, **kw), ticks)
    assert port[1] == jax_side[1] == []
    assert port[2] == jax_side[2]  # every checksum of the stream
    for n in port[0].world.comps:
        assert np.array_equal(to_numpy(port[0].world.comps[n]),
                              np.asarray(jax_side[0].world.comps[n])), n
    return port[0].world


def test_three_level_chains_preserved():
    w = both()
    parent = w.comps[PARENT].numpy()
    depth = w.comps["depth"].numpy()
    alive = TS.active_mask(w).numpy()
    for slot in range(12):
        assert alive[slot]
        if depth[slot] > 0:
            p = parent[slot]
            assert alive[p] and depth[p] == depth[slot] - 1  # chain intact
    assert np.all(w.comps["age"].numpy()[:12] == 20)


def test_child_despawn_across_rollback():
    w = both(despawn_leaf_at=8)
    alive = TS.active_mask(w).numpy()
    depth, has = w.comps["depth"].numpy(), w.has["depth"].numpy()
    for slot in range(12):
        if has[slot] and alive[slot]:
            assert depth[slot] < 2  # leaves gone, inner nodes alive
    assert sum(alive[:12]) == 8


def test_recursive_root_despawn_takes_subtree():
    w = both(despawn_root_at=6)
    alive = TS.active_mask(w).numpy()
    assert not alive[0] and not alive[1] and not alive[2]
    assert alive[3] and alive[4] and alive[5]


# -- despawn_recursive against the JAX fixpoint --------------------------------


def _regs(cap):
    j_reg, t_reg = JS.Registry(cap), TS.Registry(cap)
    j_reg.register_hierarchy()
    t_reg.register_hierarchy()
    return j_reg, t_reg


def _world_leaves(cap, rng, kind):
    """A seeded world's leaves: ``alive``, ``has[PARENT]`` and the parent
    column, shaped by ``kind``."""
    if kind == "random":
        alive = rng.random(cap) < 0.8
        has = rng.random(cap) < 0.9
        parent = rng.integers(-3, cap + 4, cap).astype(np.int32)
    elif kind == "full":
        alive = np.ones(cap, bool)
        has = np.ones(cap, bool)
        parent = rng.integers(-1, cap, cap).astype(np.int32)
    elif kind == "forest":  # trees: each node's parent is an earlier slot
        alive = rng.random(cap) < 0.9  # dead links break chains
        has = rng.random(cap) < 0.95  # so do missing parent components
        parent = np.array([-1] + [rng.integers(-1, i) for i in range(1, cap)], np.int32)
    else:  # "chain": one path through every slot, in a shuffled order
        order = rng.permutation(cap)
        parent = np.full(cap, -1, np.int32)
        parent[order[1:]] = order[:-1]
        alive = np.ones(cap, bool)
        has = np.ones(cap, bool)
    return alive, has, parent


def _worlds(j_reg, t_reg, alive, has, parent):
    jw = j_reg.init_state()
    jw = dataclasses.replace(
        jw, alive=jnp.asarray(alive), has={PARENT: jnp.asarray(has)},
        comps={PARENT: jnp.asarray(parent)},
        rollback_id=jnp.where(jnp.asarray(alive), jnp.arange(len(alive), dtype=jnp.int32), -1))
    leaves = jax.tree.map(np.asarray, {f.name: getattr(jw, f.name)
                                       for f in dataclasses.fields(jw)})
    return jw, world_from_numpy(t_reg, leaves, "cpu")


@pytest.mark.parametrize("cap", [1, 2, 7, 64])
@pytest.mark.parametrize("kind", ["random", "full", "forest", "chain"])
def test_despawn_recursive_equals_jax_fixpoint(cap, kind):
    j_reg, t_reg = _regs(cap)
    rng = np.random.default_rng(cap * 31 + len(kind))
    for trial in range(2):
        jw, tw = _worlds(j_reg, t_reg, *_world_leaves(cap, rng, kind))
        for slot in sorted({0, cap - 1, int(rng.integers(0, cap)), -1, cap}):
            want = JS.despawn_recursive(j_reg, jw, slot, 40 + trial)
            got = TS.despawn_recursive(t_reg, tw, slot, 40 + trial)
            assert np.array_equal(got.despawn_pending.numpy(),
                                  np.asarray(want.despawn_pending)), (trial, slot)
            assert np.array_equal(got.despawn_frame.numpy(),
                                  np.asarray(want.despawn_frame)), (trial, slot)
            # a tensor slot (a device scalar) marks the same subtree
            got_t = TS.despawn_recursive(t_reg, tw, torch.tensor(slot, dtype=torch.int32),
                                         torch.tensor(40 + trial, dtype=torch.int32))
            assert torch.equal(got_t.despawn_pending, got.despawn_pending)
            assert torch.equal(got_t.despawn_frame, got.despawn_frame)


def test_despawn_recursive_batches_under_vmap():
    """Lanes of different worlds, slots and frames through
    ``torch.func.vmap``: each lane equals its own solo call (a host read
    inside, such as ``bool(tensor)``, would raise under ``vmap``)."""
    cap, lanes = 32, 5
    j_reg, t_reg = _regs(cap)
    rng = np.random.default_rng(9)
    worlds = [_worlds(j_reg, t_reg, *_world_leaves(cap, rng, "forest"))[1]
              for _ in range(lanes)]
    slots = torch.tensor([0, 3, 31, -1, 7], dtype=torch.int32)
    frames = torch.tensor([5, 6, 7, 8, 9], dtype=torch.int32)
    stacked = tree_map(lambda *xs: torch.stack(xs), *worlds)

    def one(leaves, slot, frame):
        w = TS.despawn_recursive(t_reg, tree_unflatten(worlds[0], leaves), slot, frame)
        return tree_flatten(w)

    out = tree_unflatten(worlds[0], torch.func.vmap(one)(tree_flatten(stacked), slots, frames))
    for b in range(lanes):
        solo = TS.despawn_recursive(t_reg, worlds[b], int(slots[b]), int(frames[b]))
        assert torch.equal(out.despawn_pending[b], solo.despawn_pending)
        assert torch.equal(out.despawn_frame[b], solo.despawn_frame)
