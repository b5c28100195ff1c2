"""The PyTorch port's k-frame resim against the JAX package's.

Integer models are held bit for bit: ``fixed_point``'s per-frame checksums
and states from the port's ``resim_fn`` equal the JAX ``app.resim_fn``'s
over the 12-frame script of ``scripts/parity_check.py`` (inputs from
``default_rng(7).integers(0, 16)``), and so do ``resim_padded`` and the
canonical function at ``canonical_depth=8`` for every ``n_real``.

Float models are held to ``atol=1e-4, rtol=0`` on their states.  The
reason: XLA on the CPU contracts ``a*b + c`` into fused multiply-adds and
torch eager does not, so the last bits differ; over 8 frames at
``|x| <= 50`` that gap measured at most 1.53e-5.  The checksums of the JAX
stacked states, recomputed by the port, must still equal the JAX
checksums exactly — the checksum is exact on identical bits."""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bevy_ggrs_tpu_torch.ops.resim as tr
from bevy_ggrs_tpu import App as JApp
from bevy_ggrs_tpu.models import box_game as j_box_game
from bevy_ggrs_tpu.models import fixed_point as j_fixed_point
from bevy_ggrs_tpu.models import stress_soa as j_stress_soa
from bevy_ggrs_tpu.snapshot import active_mask as j_active_mask
from bevy_ggrs_tpu.snapshot import despawn_where as j_despawn_where
from bevy_ggrs_tpu.snapshot import spawn as j_spawn
from bevy_ggrs_tpu_torch import App as TApp
from bevy_ggrs_tpu_torch.convert import world_from_numpy, world_to_numpy
from bevy_ggrs_tpu_torch.models import box_game as t_box_game
from bevy_ggrs_tpu_torch.models import fixed_point as t_fixed_point
from bevy_ggrs_tpu_torch.models import stress_soa as t_stress_soa
from bevy_ggrs_tpu_torch.snapshot import active_mask as t_active_mask
from bevy_ggrs_tpu_torch.snapshot import checksum_to_int, world_checksums
from bevy_ggrs_tpu_torch.snapshot import despawn_where as t_despawn_where
from bevy_ggrs_tpu_torch.snapshot import spawn as t_spawn

# the package re-exports a function named ``resim`` over its module
jr = importlib.import_module("bevy_ggrs_tpu.ops.resim")

FLOAT_ATOL = 1e-4  # FMA contraction in XLA's CPU code, absent in torch eager


def jax_leaves(w) -> dict:
    return {f.name: jax.tree.map(np.asarray, getattr(w, f.name))
            for f in dataclasses.fields(w)}


def script(k: int, players: int = 2):
    """scripts/parity_check.py's inputs."""
    rng = np.random.default_rng(7)
    inputs = rng.integers(0, 16, (k, players)).astype(np.uint8)
    return inputs, np.zeros((k, players), np.int8)


def j_ints(checks):
    return [int(v) for v in np.asarray(checks).astype(np.uint64) @ np.array(
        [1 << 32, 1], np.uint64)]


def t_ints(checks):
    return [checksum_to_int(c) for c in checks]


def assert_stacked_equal(jstacked, tstacked, atol=0.0):
    want, got = jax_leaves(jstacked), world_to_numpy(tstacked)
    for field in ("comps", "has"):
        for n in want[field]:
            a, b = want[field][n], got[field][n]
            assert a.dtype == b.dtype and a.shape == b.shape, (field, n)
            if atol:
                np.testing.assert_allclose(b, a, rtol=0, atol=atol, err_msg=n)
            else:
                assert np.array_equal(a, b), (field, n)
    for field in ("alive", "rollback_id", "despawn_pending", "despawn_frame",
                  "next_id"):
        assert np.array_equal(want[field], got[field]), field


def test_fixed_point_scripted_resim_bit_exact():
    inputs, status = script(12)
    japp, tapp = j_fixed_point.make_app(), t_fixed_point.make_app(device="cpu")
    jfinal, jstacked, jchecks = japp.resim_fn(japp.init_state(), inputs, status, 0, -1)
    tfinal, tstacked, tchecks = tapp.resim_fn(tapp.init_state(), inputs, status, 0)
    assert t_ints(tchecks) == j_ints(jchecks)
    assert_stacked_equal(jstacked, tstacked)
    assert np.array_equal(world_to_numpy(tfinal)["comps"]["pos"],
                          np.asarray(jfinal.comps["pos"]))


@pytest.mark.parametrize("n_real", range(1, 9))
def test_fixed_point_padded_and_canonical_bit_exact(n_real):
    k_max = 8
    inputs, status = script(k_max)
    japp, tapp = j_fixed_point.make_app(), t_fixed_point.make_app(device="cpu")
    jw0, tw0 = japp.init_state(), tapp.init_state()
    j = jr.resim_padded(japp.reg, japp.step, jw0, inputs, status, 3, n_real,
                        16, japp.fps)
    t = tr.resim_padded(tapp.reg, tapp.step, tw0, inputs, status, 3, n_real,
                        16, tapp.fps)
    assert t_ints(t[2]) == j_ints(j[2])
    assert_stacked_equal(j[1], t[1])
    jfn = jr.make_canonical_resim_fn(japp.reg, japp.step, japp.fps, k_max=k_max)
    tfn = tr.make_canonical_resim_fn(tapp.reg, tapp.step, tapp.fps, k_max=k_max)
    jc = jfn(jw0, inputs[:n_real], status[:n_real], 3)
    tc = tfn(tw0, inputs[:n_real], status[:n_real], 3)
    assert len(tc[2]) == n_real
    assert t_ints(tc[2]) == j_ints(jc[2])
    assert_stacked_equal(jc[1], tc[1])


def test_advance_fn_matches_jax():
    inputs, status = script(1)
    japp, tapp = j_fixed_point.make_app(), t_fixed_point.make_app(device="cpu")
    jw, jcs = japp.advance_fn(japp.init_state(), inputs[0], status[0], 5)
    tw, tcs = tapp.advance_fn(tapp.init_state(), inputs[0], status[0], 5)
    assert t_ints([tcs]) == j_ints([jcs])
    assert np.array_equal(tw.comps["vel"].numpy(), np.asarray(jw.comps["vel"]))


@pytest.mark.parametrize("model", ["stress_soa", "box_game"])
def test_float_models_within_tolerance_and_checksums_exact(model):
    k = 8
    if model == "stress_soa":
        japp = j_stress_soa.make_app(n_entities=512)
        tapp = t_stress_soa.make_app(n_entities=512, device="cpu")
    else:
        japp, tapp = j_box_game.make_app(), t_box_game.make_app(device="cpu")
    inputs, status = script(k)
    _, jstacked, jchecks = japp.resim_fn(japp.init_state(), inputs, status, 0, -1)
    _, tstacked, _ = tapp.resim_fn(tapp.init_state(), inputs, status, 0)
    assert_stacked_equal(jstacked, tstacked, atol=FLOAT_ATOL)
    carried = world_from_numpy(tapp.reg, jax_leaves(jstacked), "cpu")
    assert t_ints(world_checksums(tapp.reg, carried)) == j_ints(jchecks)


def _counter_apps(despawn_at):
    """An int32 counter that despawns at a frame: the retirement sweep at
    the head of every advance frees the slot ``retention`` frames later."""

    def make(App, spawn, despawn_where, active_mask, where, i32, **kw):
        app = App(num_players=1, capacity=4, retention=3, **kw)
        app.rollback_component("counter", (), i32, checksum=True)

        def step(world, ctx):
            mask = active_mask(world) & world.has["counter"]
            cnt = where(mask, world.comps["counter"] + 1, world.comps["counter"])
            world = dataclasses.replace(world, comps={"counter": cnt})
            return despawn_where(app.reg, world, mask & (ctx.frame == despawn_at),
                                 ctx.frame)

        app.set_step(step)
        app.set_setup(lambda w: spawn(app.reg, spawn(app.reg, w, {"counter": 0})[0],
                                      {"counter": 5})[0])
        return app

    return (make(JApp, j_spawn, j_despawn_where, j_active_mask, jnp.where, jnp.int32),
            make(TApp, t_spawn, t_despawn_where, t_active_mask, torch.where,
                 torch.int32, device="cpu"))


def test_despawn_retirement_inside_resim_bit_exact():
    japp, tapp = _counter_apps(despawn_at=4)
    inputs = np.zeros((10, 1), np.uint8)
    status = np.zeros((10, 1), np.int8)
    _, jstacked, jchecks = japp.resim_fn(japp.init_state(), inputs, status, 0, -1)
    _, tstacked, tchecks = tapp.resim_fn(tapp.init_state(), inputs, status, 0)
    assert t_ints(tchecks) == j_ints(jchecks)
    assert_stacked_equal(jstacked, tstacked)
    alive = world_to_numpy(tstacked)["alive"]
    assert alive[5].tolist() == [True, True, False, False]  # pending, allocated
    assert alive[7].tolist() == [False, False, False, False]  # retired at 4 + 3
