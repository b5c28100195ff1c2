"""The PyTorch port's checksums against the JAX package's, bit for bit.

A world is built in the JAX package from seeded numpy inputs, its leaves
are carried into the port with ``convert.world_from_numpy``, and the
port's ``world_checksum`` / ``checksum_to_int`` / parts must equal the
JAX values exactly.  Every ``to_u32_lanes`` dtype branch is covered, with
despawned rows, rows without the component, a custom ``hash_fn`` and an
absent resource.  64-bit columns are built under ``jax.enable_x64``.  The
port runs on the CPU, where the checksum fold takes its plain version."""

import ctypes
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bevy_ggrs_tpu.snapshot.checksum as jc
import bevy_ggrs_tpu.snapshot.world as jw
import bevy_ggrs_tpu_torch.snapshot.checksum as tc
import bevy_ggrs_tpu_torch.snapshot.world as tw
from bevy_ggrs_tpu_torch.convert import world_from_numpy
from bevy_ggrs_tpu_torch.ops import checksum_fold as cf
from bevy_ggrs_tpu_torch.utils.tree import tree_map

CAP = 48

# name -> (jax dtype, torch dtype, per-entity shape)
DTYPES = {
    "float32": (jnp.float32, torch.float32, (2,)),
    "int32": (jnp.int32, torch.int32, ()),
    "uint32": (jnp.uint32, torch.uint32, (3,)),
    "bfloat16": (jnp.bfloat16, torch.bfloat16, (3,)),
    "float16": (jnp.float16, torch.float16, ()),
    "float64": (jnp.float64, torch.float64, (2,)),
    "int64": (jnp.int64, torch.int64, (3,)),
    "bool": (jnp.bool_, torch.bool, ()),
    "int8": (jnp.int8, torch.int8, (4,)),
    "int16": (jnp.int16, torch.int16, (2,)),
}


def jax_leaves(w) -> dict:
    return {f.name: jax.tree.map(np.asarray, getattr(w, f.name))
            for f in dataclasses.fields(w)}


def column_values(rng, name, shape, rows):
    size = (rows, *shape)
    if name == "bool":
        return rng.integers(0, 2, size).astype(bool)
    if name.startswith("float") or name == "bfloat16":
        return (rng.standard_normal(size) * 100).astype(np.float32 if name != "float64"
                                                        else np.float64)
    info = np.iinfo(np.dtype(name))
    return rng.integers(max(info.min, -2**62), min(info.max, 2**62), size,
                        dtype=np.int64).astype(name)


def build_pair(name, seed, hash_fns=(None, None)):
    """The same world in both packages: a column of dtype ``name``, an int32
    column (optionally with a custom hash), a dict resource and an absent
    resource; some rows despawned, some without the column."""
    jdt, tdt, shape = DTYPES[name]
    rng = np.random.default_rng(seed)
    jreg, treg = jw.Registry(CAP), tw.Registry(CAP)
    for reg, dt, i32, hf in ((jreg, jdt, jnp.int32, hash_fns[0]),
                             (treg, tdt, torch.int32, hash_fns[1])):
        reg.register_component("col", shape, dt, checksum=True)
        reg.register_component("id", (), i32, checksum=True, hash_fn=hf)
        reg.register_component("plain", (), i32)
        reg.register_resource("env", {"g": np.float32(-9.8), "n": np.int32(7)},
                              checksum=True)
        reg.register_resource("gone", np.int32(3), checksum=True, present=False)
    rows = CAP - 5
    vals = column_values(rng, name, shape, rows)
    ids = rng.integers(-1000, 1000, rows).astype(np.int32)
    w = jreg.init_state()
    w = jw.spawn_many(jreg, w, {"col": jnp.asarray(vals, jdt), "id": ids}, rows - 3)
    w = jw.despawn_where(jreg, w, jnp.asarray(rng.random(CAP) < 0.2), 4)
    for slot in rng.integers(0, rows, 4):
        w = jw.remove_component(jreg, w, int(slot), "col")
    return jreg, w, treg, world_from_numpy(treg, jax_leaves(w), "cpu")


@pytest.mark.parametrize("name", sorted(DTYPES))
def test_world_checksum_bit_exact_per_dtype(name):
    with jax.enable_x64(name in ("float64", "int64")):
        jreg, jworld, treg, tworld = build_pair(name, seed=len(name))
        want = np.asarray(jc.world_checksum(jreg, jworld)).astype(np.int64)
        want_lanes = np.asarray(jc.to_u32_lanes(jworld.comps["col"])).astype(np.int64)
        want_parts = [int(jc.component_part(jreg, jworld, "col", s)) for s in (1, 99)]
        want_int = jc.checksum_to_int(jc.world_checksum(jreg, jworld))
    got = tc.world_checksum(treg, tworld)
    assert got.tolist() == want.tolist()
    assert tc.checksum_to_int(got) == want_int
    assert np.array_equal(tc.to_u32_lanes(tworld.comps["col"]).numpy(), want_lanes)
    assert [int(tc.component_part(treg, tworld, "col", s)) for s in (1, 99)] == want_parts


def test_custom_hash_fn_and_resource_parts():
    jreg, jworld, treg, tworld = build_pair(
        "float32", seed=3,
        hash_fns=(lambda col: col * 31 + 5, lambda col: col * 31 + 5),
    )
    jreg.resources["env"] = dataclasses.replace(
        jreg.resources["env"], hash_fn=lambda r: jnp.stack([r["n"], r["n"] * 3]))
    treg.resources["env"] = dataclasses.replace(
        treg.resources["env"], hash_fn=lambda r: torch.stack([r["n"], r["n"] * 3]))
    for seed in (jc._SEED_HI, jc._SEED_LO):
        for n in ("env", "gone"):
            assert int(tc.resource_part(treg, tworld, n, seed)) == \
                int(jc.resource_part(jreg, jworld, n, seed))
        assert int(tc.component_part(treg, tworld, "id", seed)) == \
            int(jc.component_part(jreg, jworld, "id", seed))
        assert int(tc.entity_part(tworld, seed)) == int(jc.entity_part(jworld, seed))
    assert tc.checksum_to_int(tc.world_checksum(treg, tworld)) == \
        jc.checksum_to_int(jc.world_checksum(jreg, jworld))


def test_app_checksum_registration_equals_jax():
    """``checksum_component`` / ``checksum_resource`` on an App opt a
    registered column and resource in, with a custom hash, as in JAX."""
    from bevy_ggrs_tpu import App as JApp
    from bevy_ggrs_tpu_torch import App as TApp

    apps = (JApp(capacity=8), TApp(capacity=8, device="cpu"))
    for app, i32 in zip(apps, (jnp.int32, torch.int32)):
        app.rollback_component("hp", (), i32, default=np.int32(9), required=True)
        app.rollback_resource("round", np.int32(4))
        app.checksum_component("hp", hash_fn=lambda col: col * 3)
        app.checksum_resource("round")
    jworld = jw.spawn(apps[0].reg, apps[0].init_state(), {})[0]
    tworld = tw.spawn(apps[1].reg, apps[1].init_state(), {})[0]
    assert tc.checksum_to_int(apps[1].checksum_fn(tworld)) == \
        jc.checksum_to_int(apps[0].checksum_fn(jworld))


def test_resource_presence_changes_the_checksum_as_in_jax():
    jreg, jworld, treg, tworld = build_pair("int32", seed=8)
    jworld = jw.insert_resource(jreg, jworld, "gone", np.int32(11))
    tworld = tw.insert_resource(treg, tworld, "gone", np.int32(11))
    jworld = jw.remove_resource(jreg, jworld, "env")
    tworld = tw.remove_resource(treg, tworld, "env")
    assert tc.checksum_to_int(tc.world_checksum(treg, tworld)) == \
        jc.checksum_to_int(jc.world_checksum(jreg, jworld))


def test_world_without_checksummed_types_equals_jax():
    jreg, treg = jw.Registry(4), tw.Registry(4)
    jreg.register_component("a", (), jnp.int32)
    treg.register_component("a", (), torch.int32)
    jworld = jw.spawn(jreg, jreg.init_state(), {"a": 3})[0]
    tworld = tw.spawn(treg, treg.init_state("cpu"), {"a": 3})[0]
    assert tc.checksum_to_int(tc.world_checksum(treg, tworld)) == \
        jc.checksum_to_int(jc.world_checksum(jreg, jworld))


def test_stacked_checksums_equal_per_frame_checksums():
    _, _, treg, tworld = build_pair("float32", seed=4)
    frames = [tworld]
    for f in range(3):
        frames.append(tw.despawn(treg, frames[-1], f, 10 + f))
    stacked = tree_map(lambda *xs: torch.stack(xs), *frames)
    per_frame = torch.stack([tc.world_checksum(treg, w) for w in frames])
    assert torch.equal(tc.world_checksums(treg, stacked), per_frame)


def test_mix32_and_fmix32_equal_jax_on_random_u32():
    rng = np.random.default_rng(0)
    h = rng.integers(0, 2**32, 1000, dtype=np.uint64).astype(np.uint32)
    k = rng.integers(0, 2**32, 1000, dtype=np.uint64).astype(np.uint32)
    want_mix = np.asarray(jc.mix32(jnp.asarray(h), jnp.asarray(k)))
    want_fmix = np.asarray(jc.fmix32(jnp.asarray(h)))
    th, tk = torch.from_numpy(h.astype(np.int64)), torch.from_numpy(k.astype(np.int64))
    assert np.array_equal(tc.mix32(th, tk).numpy(), want_mix.astype(np.int64))
    assert np.array_equal(tc.fmix32(th).numpy(), want_fmix.astype(np.int64))


def test_fold_wrapper_takes_plain_version_only_on_cpu():
    _, _, treg, tworld = build_pair("int32", seed=2)
    before = cf.launches
    stacked = tree_map(lambda a: a.unsqueeze(0), tworld)
    args = tc.fold_inputs(treg, stacked, ["col", "id"], seeds=(1, 2))
    assert torch.equal(cf.checksum_fold(*args), cf.checksum_fold_plain(*args))
    assert cf.launches == before  # the plain version is not a launch
    with pytest.raises(ValueError, match="int32"):
        cf.checksum_fold([a.to(torch.int64) for a in args[0]], *args[1:])


# -- the whole pass over a stack of frames, frame by frame against JAX --------

# case -> (columns {name: (jax dtype, torch dtype, shape)}, rows, frames,
#          options); every case despawns rows (pending, then retired) and
#          removes components from rows as its frames go by.
STACK_COLS = {
    "f32_L1": {"a": (jnp.float32, torch.float32, ())},
    "f32_L2": {"a": (jnp.float32, torch.float32, (2,))},
    "bf16_L3": {"a": (jnp.bfloat16, torch.bfloat16, (3,))},
    "f64_L4": {"a": (jnp.float64, torch.float64, (2,))},
    "int8_L5": {"a": (jnp.int8, torch.int8, (5,))},
    "i64_L6": {"a": (jnp.int64, torch.int64, (3,))},
    "bool_L7": {"a": (jnp.bool_, torch.bool, (7,))},
}
_MIX = [(jnp.float32, torch.float32, ()), (jnp.int32, torch.int32, (2,)),
        (jnp.float32, torch.float32, (3,)), (jnp.int8, torch.int8, ())]
STACK_CASES = {
    **{name: (cols, 61, 5, {}) for name, cols in STACK_COLS.items()},
    "masks_heavy": ({"a": (jnp.float32, torch.float32, (2,)),
                     "b": (jnp.int32, torch.int32, ())}, 40, 6, {"churn": 0.3}),
    "ragged_n_1003": ({"a": (jnp.float32, torch.float32, ()),
                       "b": (jnp.int32, torch.int32, (2,))}, 1003, 4, {}),
    "20_components": ({f"c{i}": _MIX[i % 4] for i in range(20)}, 64, 3, {}),
    "k1": ({"a": (jnp.float32, torch.float32, ())}, 64, 1, {}),
    "k17": ({"a": (jnp.float32, torch.float32, ()),
             "b": (jnp.int32, torch.int32, ())}, 64, 17, {}),
    "custom_hash_fn": ({"a": (jnp.int32, torch.int32, ()),
                        "b": (jnp.float32, torch.float32, (2,))}, 50, 4, {"hash": "a"}),
    "checksummed_resource": ({"a": (jnp.float32, torch.float32, ())}, 50, 4,
                             {"resource": True}),
    "no_checksummed_component": ({}, 50, 4, {}),
}


def _jax_name(jdt) -> str:
    return np.dtype(jdt).name


def stacked_pair(cols, rows, k, opts, seed):
    """The same ``k`` frames in both packages: JAX frames (a list) and the
    port's stacked world on the CPU."""
    rng = np.random.default_rng(seed)
    jreg, treg = jw.Registry(rows), tw.Registry(rows)
    hashed = opts.get("hash")
    for name, (jdt, tdt, shape) in cols.items():
        jreg.register_component(name, shape, jdt, checksum=True,
                                hash_fn=(lambda c: c * 31 + 5) if name == hashed else None)
        treg.register_component(name, shape, tdt, checksum=True,
                                hash_fn=(lambda c: c * 31 + 5) if name == hashed else None)
    for reg, i32 in ((jreg, jnp.int32), (treg, torch.int32)):
        reg.register_component("unsummed", (), i32)
        if opts.get("resource"):
            reg.register_resource("env", {"g": np.float32(-9.8), "n": np.int32(7)},
                                  checksum=True)

    def values():
        vals = {n: jnp.asarray(column_values(rng, _jax_name(jdt), shape, rows), jdt)
                for n, (jdt, _, shape) in cols.items()}
        return {**vals, "unsummed": jnp.asarray(rng.integers(0, 9, rows), jnp.int32)}

    churn = opts.get("churn", 0.08)
    w = jw.spawn_many(jreg, jreg.init_state(), values(), rows - 3)
    frames = []
    for f in range(k):
        w = jw.despawn_where(jreg, w, jnp.asarray(rng.random(rows) < churn), f)
        if f % 2 == 1:
            w = jw.despawn_confirmed(jreg, w, f - 1)
        for slot in rng.integers(0, rows, 3):
            for name in cols:
                w = jw.remove_component(jreg, w, int(slot), name)
        w = dataclasses.replace(w, comps={**w.comps, **values()})
        if opts.get("resource"):
            w = jw.insert_resource(jreg, w, "env", {"g": np.float32(f * 0.5),
                                                    "n": np.int32(f - 3)})
        frames.append(w)
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *frames)
    return jreg, frames, treg, world_from_numpy(treg, jax_leaves(stacked), "cpu")


@pytest.mark.parametrize("case", sorted(STACK_CASES))
def test_stacked_checksum_pass_equals_jax_frame_by_frame(case):
    cols, rows, k, opts = STACK_CASES[case]
    x64 = any(jdt in (jnp.float64, jnp.int64) for jdt, _, _ in cols.values())
    with jax.enable_x64(x64):
        jreg, frames, treg, stacked = stacked_pair(cols, rows, k, opts, seed=len(case))
        checksum = jax.jit(lambda w: jc.world_checksum(jreg, w))
        want = [jc.checksum_to_int(checksum(w)) for w in frames]
        names = list(cols)
        want_parts = [[int(jc.component_part(jreg, frames[f], n, s)) for n in names]
                      for f in (0, k - 1) for s in tc.SEEDS]
    got = tc.world_checksums(treg, stacked)
    assert got.shape == (k, 2)
    assert [tc.checksum_to_int(c) for c in got] == want
    parts = tc.component_parts(treg, stacked, names)
    assert [parts[f, :, s].tolist() for f in (0, k - 1) for s in (0, 1)] == want_parts
    # the plain version is what the CPU path ran; its first row is the pass
    # without resource parts
    plain = cf.checksum_fold_plain(*tc.fold_inputs(treg, stacked, names))
    assert torch.equal(plain[:, 1:], parts)
    if not opts.get("resource"):
        assert torch.equal(plain[:, 0], got)


# -- the kernel's parameter block, packed in Python ----------------------------


def _fold_args(n_comps, rows=40, k=3, lanes_of=lambda c: c % 3 + 1):
    """checksum_fold arguments for ``n_comps`` components on the CPU."""
    lanes = [torch.zeros((k, rows, lanes_of(c)), dtype=torch.int32) for c in range(n_comps)]
    has = [torch.ones((k, rows), dtype=torch.bool) for _ in range(n_comps)]
    ids = torch.zeros((k, rows), dtype=torch.int32)
    alive = torch.ones((k, rows), dtype=torch.bool)
    pending = torch.zeros((k, rows), dtype=torch.bool)
    tags = [(0x1_0000_0000 + 7 * c, 2**32 - 1 - c) for c in range(n_comps)]
    return lanes, has, ids, alive, pending, tags, torch.zeros(k, dtype=torch.int32), (11, 12)


@pytest.mark.parametrize("n_comps,chunks", [(0, [(0, 0)]), (6, [(0, 6)]),
                                             (16, [(0, 16)]), (20, [(0, 16), (16, 4)]),
                                             (33, [(0, 16), (16, 16), (32, 1)])])
def test_pack_params_order_tags_and_chunks(n_comps, chunks):
    args = _fold_args(n_comps)
    lanes, has, ids, alive, pending, tags, next_id, _ = args
    out = torch.empty((3, 1 + n_comps, 2), dtype=torch.int64)
    packed = cf.pack_params(*args, out, partials=4096, blocks_x=5, vec=True)
    assert [(p.comp0, p.ncomp) for p in packed] == chunks
    for p in packed:
        assert (p.k, p.n, p.ncomp_total, p.blocks_x, p.vec) == (3, 40, n_comps, 5, 1)
        assert (p.ids, p.alive, p.pending, p.next_id) == (
            ids.data_ptr(), alive.data_ptr(), pending.data_ptr(), next_id.data_ptr())
        assert (p.out, p.partials) == (out.data_ptr(), 4096)
        assert list(p.entity_tag) == [11, 12]
        for i in range(p.ncomp):
            c = p.comp0 + i
            assert (p.comp[i].lanes, p.comp[i].has) == (lanes[c].data_ptr(), has[c].data_ptr())
            assert p.comp[i].nlanes == lanes[c].shape[2]
            assert list(p.comp[i].tag) == [t & cf.MASK32 for t in tags[c]]
    # the block mirrors the kernel's Params: 16 components of 32 bytes, 6
    # pointers, n, the entity tags and 6 int32 fields
    assert ctypes.sizeof(cf.FoldParams) == 16 * 32 + 6 * 8 + 8 + 8 + 6 * 4
    assert cf._PARAMS.size == ctypes.sizeof(cf.FoldParams)


@pytest.mark.parametrize("rows,lo,hi,want", [(40, 0, 3, True), (40, 1, 3, True),
                                             (41, 0, 3, False), (64, 0, 2, True),
                                             (42, 1, 3, False), (42, 0, 2, False)])
def test_vector_loads_need_aligned_bases_and_rows(rows, lo, hi, want):
    """16-byte loads need n % 4 == 0 and 16-byte aligned bases; a frame
    slice keeps them only where a frame's bytes are a multiple of 16."""
    lanes, has, ids, alive, pending, *_ = _fold_args(2, rows=rows, k=4)
    sl = [t[lo:hi] for t in (ids, alive, pending, *lanes, *has)]
    aligned = rows % 16 == 0 or lo == 0
    assert cf.vector_loads(rows, sl) == (want and aligned)


@pytest.mark.parametrize("k,n,vec,want", [(8, 1_000_000, True, 66), (1, 1_000_000, True, 528),
                                          (17, 100_000, True, 32), (8, 64, True, 1),
                                          (8, 100_003, False, 66), (8, 3000, False, 12)])
def test_grid_blocks_fill_the_card_and_stop_at_the_rows(k, n, vec, want):
    blocks = cf.grid_blocks(k, n, sm_count=132, vec=vec)
    assert blocks == want
    assert cf.partial_words(k, 20, blocks) == k * 33 * blocks
