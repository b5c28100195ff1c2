"""The port's threefry (``bevy_ggrs_tpu_torch/utils/threefry.py``) against
``jax.random`` on the CPU, bit for bit: ``PRNGKey``, ``fold_in`` (host ints
and tensors, counters that wrap past 2**32), ``split``, ``bits`` and
``uniform`` at the shapes particles draws, at odd and even sizes, under
``torch.func.vmap``; and ``StepCtx.rng_key``, which costs no launch when
a step does not read it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bevy_ggrs_tpu_torch.models import stress_soa
from bevy_ggrs_tpu_torch.ops.resim import StepCtx
from bevy_ggrs_tpu_torch.utils import threefry

SEEDS = [0, 1, 2**31 - 1, -1, 2**32 + 5]
COUNTERS = [0, 1, 7, 2**31, 2**32 - 1, 2**32, 2**32 + 3, 2**40 + 11]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def jwords(key) -> list:
    return np.asarray(key).astype(np.int64).tolist()


def twords(key) -> list:
    return key.tolist() if isinstance(key, torch.Tensor) else list(key)


def test_written_against_the_partitionable_variant():
    # split and bits differ between the two variants; the port follows this one
    assert jax.config.jax_threefry_partitionable is True


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key(seed):
    assert twords(threefry.prng_key(seed)) == jwords(jax.random.PRNGKey(seed))
    if seed == -1:
        assert twords(threefry.prng_key(seed)) == [0, 0xFFFFFFFF]
    if seed == 2**32 + 5:
        assert twords(threefry.prng_key(seed)) == [0, 5]


@pytest.mark.parametrize("seed", SEEDS)
def test_fold_in_host_and_tensor(seed):
    jkey = jax.random.PRNGKey(seed)
    for c in COUNTERS:
        want = jwords(jax.random.fold_in(jkey, np.uint32(c & 0xFFFFFFFF)))
        assert twords(threefry.fold_in(threefry.prng_key(seed), c)) == want
        # an int64 tensor wraps to its low word; a uint32 tensor by its bits
        assert twords(threefry.fold_in(threefry.prng_key(seed),
                                       torch.tensor(c, dtype=torch.int64))) == want
        u32 = torch.tensor(c & 0xFFFFFFFF, dtype=torch.int64).to(torch.int32)
        assert twords(threefry.fold_in(threefry.prng_key(seed),
                                       u32.view(torch.uint32))) == want
        # an int32 frame past I32_MAX: uint32(frame) is its bit pattern
        frame = ((c + 2**31) % 2**32) - 2**31
        assert twords(threefry.fold_in(threefry.prng_key(seed),
                                       torch.tensor(frame, dtype=torch.int32))) == want


@pytest.mark.parametrize("num", [2, 3, 8])
def test_split(num):
    rng = np.random.default_rng(num)
    for c in rng.integers(0, 2**32, 5, dtype=np.uint64):
        jkey = jax.random.fold_in(jax.random.PRNGKey(3), np.uint32(c))
        want = jwords(jax.random.split(jkey, num))
        tkey = threefry.fold_in(threefry.prng_key(3), torch.tensor(int(c)))
        assert twords(threefry.split(tkey, num)) == want
        host = threefry.fold_in(threefry.prng_key(3), int(c))
        assert [list(k) for k in threefry.split(host, num)] == want


@pytest.mark.parametrize("rate", [1, 4, 5, 100, 101])
def test_bits_and_uniform_at_the_particles_shapes(rate):
    for c in (0, 9, 2**32 - 1):
        jkv, jkp = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(0), np.uint32(c)))
        tkv, tkp = threefry.split(threefry.fold_in(threefry.prng_key(0), torch.tensor(c)))
        for jk, tk, shape in ((jkv, tkv, (rate, 3)), (jkp, tkp, (rate,))):
            want = np.asarray(jax.random.bits(jk, shape, jnp.uint32)).astype(np.int64)
            assert np.array_equal(threefry.random_bits(tk, shape).numpy(), want)
        # particles' two draws: x4 - 2 and x1 + 0 are exact, so bit for bit
        jv = np.asarray(jax.random.uniform(jkv, (rate, 3), jnp.float32, minval=-2.0,
                                           maxval=2.0))
        jp = np.asarray(jax.random.uniform(jkp, (rate,), jnp.float32))
        tv = threefry.uniform(tkv, (rate, 3), -2.0, 2.0)
        tp = threefry.uniform(tkp, (rate,))
        assert tv.dtype == tp.dtype == torch.float32
        assert np.array_equal(tv.numpy().view(np.uint32), jv.view(np.uint32))
        assert np.array_equal(tp.numpy().view(np.uint32), jp.view(np.uint32))
        assert float(tv.min()) >= -2.0 and float(tv.max()) < 2.0


def test_uniform_general_range_within_one_ulp():
    """A general ``minval``/``maxval``: XLA may contract the scale and
    shift into one FMA, so a value may differ by one ulp (held at
    ``atol``); none differs more."""
    key = jax.random.PRNGKey(11)
    want = np.asarray(jax.random.uniform(key, (4096,), jnp.float32, minval=-0.3,
                                         maxval=7.7))
    got = threefry.uniform(threefry.prng_key(11), (4096,), -0.3, 7.7, device="cpu").numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    ulps = np.abs(got.view(np.int32).astype(np.int64) - want.view(np.int32).astype(np.int64))
    assert ulps.max() <= 1


def test_draws_batch_under_vmap():
    """A lane's counter folds and draws under ``torch.func.vmap`` exactly
    as it does alone (the many-worlds lane path)."""
    counters = torch.tensor([0, 5, 2**31 + 1, 2**32 - 1], dtype=torch.int64)

    def draw(c):
        kv, kp = threefry.split(threefry.fold_in(threefry.prng_key(2), c))
        return threefry.uniform(kv, (3, 3), -2.0, 2.0), threefry.uniform(kp, (3,))

    vs, ps = torch.func.vmap(draw)(counters)
    for i, c in enumerate(counters.tolist()):
        v, p = draw(torch.tensor(c))
        assert torch.equal(vs[i], v) and torch.equal(ps[i], p)


def test_step_ctx_rng_key_is_lazy_and_matches_jax():
    """``StepCtx.rng_key`` is ``fold_in(PRNGKey(seed), uint32(frame))``:
    host ints on a host clock, a tensor from a device frame; a step that
    never reads it changes nothing about what a resim launches."""
    inputs = torch.zeros(2, dtype=torch.uint8)
    status = torch.zeros(2, dtype=torch.int8)
    for seed in (0, 42):
        for frame in (0, 1, 2**31 - 1, -1, -(2**31)):
            want = jwords(jax.random.fold_in(jax.random.PRNGKey(seed),
                                             jnp.asarray(frame, jnp.int32).astype(jnp.uint32)))
            host = StepCtx(inputs, status, frame, frame - 16, np.float32(0), np.float32(0),
                           seed)
            assert twords(host.rng_key) == want
            dev = StepCtx(inputs, status, torch.tensor(frame, dtype=torch.int32), 0,
                          np.float32(0), np.float32(0), seed)
            assert twords(dev.rng_key) == want
    # a k=8 stress_soa resim never computes a key its step does not read:
    # no threefry round runs, and it makes the aten calls it made before
    # the key existed (4382 at 64 entities, counted the same way on the
    # commit before StepCtx.rng_key, torch 2.13 on the CPU)
    from torch.profiler import ProfilerActivity, profile

    app = stress_soa.make_app(n_entities=64, device="cpu")
    world = app.init_state()
    zeros = np.zeros((8, 2), np.uint8)
    app.resim_fn(world, zeros, zeros.astype(np.int8), 0)
    hashed = []
    real = threefry.threefry2x32
    threefry.threefry2x32 = lambda *a: hashed.append(1) or real(*a)
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            app.resim_fn(world, zeros, zeros.astype(np.int8), 0)
    finally:
        threefry.threefry2x32 = real
    assert hashed == []
    calls = sum(e.count for e in prof.key_averages() if e.key.startswith("aten::"))
    if torch.__version__.startswith("2.13"):
        assert calls == 4382
