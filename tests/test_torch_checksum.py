"""The PyTorch port's checksums against the JAX package's, bit for bit.

A world is built in the JAX package from seeded numpy inputs, its leaves
are carried into the port with ``convert.world_from_numpy``, and the
port's ``world_checksum`` / ``checksum_to_int`` / parts must equal the
JAX values exactly.  Every ``to_u32_lanes`` dtype branch is covered, with
despawned rows, rows without the component, a custom ``hash_fn`` and an
absent resource.  64-bit columns are built under ``jax.enable_x64``.  The
port runs on the CPU, where the checksum fold takes its plain version."""

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
