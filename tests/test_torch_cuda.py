"""Card-only tests of the PyTorch port: the checksum fold kernel against its
plain version on every lane dtype, and the entry points' CUDA default.

Marked ``cuda``; each skips without a card.  This file imports neither JAX
nor the JAX package, so it runs on a machine without JAX:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

from bevy_ggrs_tpu_torch import App, GgrsRunner, SessionBuilder
from bevy_ggrs_tpu_torch.models import fixed_point, stress_soa
from bevy_ggrs_tpu_torch.ops import checksum_fold as cf
from bevy_ggrs_tpu_torch.snapshot import (
    despawn_where,
    fold_inputs,
    remove_component,
    spawn_many,
    world_checksums,
)

pytestmark = pytest.mark.cuda

N = 5000
K = 4

DTYPES = {
    "float32": (torch.float32, (2,)),
    "int32": (torch.int32, ()),
    "uint32": (torch.uint32, (3,)),
    "bfloat16": (torch.bfloat16, (3,)),
    "float16": (torch.float16, ()),
    "float64": (torch.float64, (2,)),
    "int64": (torch.int64, ()),
    "bool": (torch.bool, ()),
    "int8": (torch.int8, (4,)),
    "int16": (torch.int16, ()),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the fold kernel runs only on the card")
    return torch.device("cuda", 0)


def _values(rng, dtype, shape):
    size = (N, *shape)
    if dtype == torch.bool:
        return torch.from_numpy(rng.integers(0, 2, size).astype(bool))
    if dtype.is_floating_point:
        return torch.from_numpy(rng.standard_normal(size)).to(dtype)
    info = torch.iinfo(dtype)
    lo, hi = max(info.min, -2**62), min(info.max, 2**62)
    return torch.from_numpy(rng.integers(lo, hi, size, dtype=np.int64)).to(dtype)


def _stacked(app, dev, seed):
    """A [K, N] stack of worlds with despawned and has-false rows."""
    rng = np.random.default_rng(seed)
    cols = {n: _values(rng, s.dtype, s.shape) for n, s in app.reg.components.items()}
    w = spawn_many(app.reg, app.init_state(), cols, N - 50)
    w = despawn_where(app.reg, w, torch.from_numpy(rng.random(N) < 0.1).to(dev), 0)
    for slot in rng.integers(0, N - 50, 20):
        w = remove_component(app.reg, w, int(slot), next(iter(app.reg.components)))
    inputs = np.zeros((K, 2), np.uint8)
    return app.resim_fn(w, inputs, np.zeros((K, 2), np.int8), 0)[1]


@pytest.mark.parametrize("name", sorted(DTYPES))
def test_fold_kernel_equals_plain(cuda, name):
    dtype, shape = DTYPES[name]
    app = App(capacity=N, device=cuda)
    app.rollback_component("c", shape, dtype, checksum=True)
    app.rollback_component("h", (), torch.int32, checksum=True,
                           hash_fn=lambda col: col * 7 + 1)
    app.set_step(lambda w, ctx: w)
    stacked = _stacked(app, cuda, seed=len(name))
    args = fold_inputs(app.reg, stacked, ["c", "h"], seeds=(1, 2))
    before = cf.launches
    got = cf.checksum_fold(*args)
    torch.cuda.synchronize()
    assert cf.launches == before + 1
    assert torch.equal(got, cf.checksum_fold_plain(*args))


def test_world_checksums_on_card_equal_cpu(cuda):
    app_gpu = stress_soa.make_app(n_entities=N, device=cuda)
    app_cpu = stress_soa.make_app(n_entities=N, device="cpu")
    stacked = _stacked(app_gpu, cuda, seed=5)
    on_cpu = type(stacked)(**{
        f: (v.cpu() if isinstance(v, torch.Tensor) else {n: t.cpu() for n, t in v.items()})
        for f, v in vars(stacked).items()
    })
    assert torch.equal(world_checksums(app_gpu.reg, stacked).cpu(),
                       world_checksums(app_cpu.reg, on_cpu))


def test_runner_launches_the_kernel(cuda):
    app = fixed_point.make_app(device=cuda)
    session = SessionBuilder.for_app(app).with_check_distance(4).start_synctest_session()
    runner = GgrsRunner(app, session)
    cf.launches = 0
    for _ in range(40):
        runner.tick()
    runner.finish()
    assert cf.launches > 0
    assert runner.rollbacks > 0


def test_entry_points_default_to_cuda(cuda):
    assert App().device.type == "cuda"
    assert fixed_point.make_app().init_state().device.type == "cuda"
