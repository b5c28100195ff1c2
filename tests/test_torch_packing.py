"""The port's packed single upload (``ops/packing.py``) against the JAX
package's, on the CPU.

Mirrors tests/test_packed.py where a case applies to a solo runner.  The
host buffers the port packs must be byte-identical to the JAX package's
for the same seeded rows (multibyte input dtypes, negative start frames,
padding), and the port's device split must give back exactly the arrays
JAX's ``unpack_seq`` gives.  A packed runner's checksum stream must equal
the two-upload runner's, and the JAX runner's (``pipeline=False``) on
fixed_point, bit for bit (tolerance 0)."""

import jax
import numpy as np
import pytest
import torch

from bevy_ggrs_tpu import GgrsRunner as JRunner
from bevy_ggrs_tpu import SyncTestSession as JSession
from bevy_ggrs_tpu.models import fixed_point as j_fixed_point
from bevy_ggrs_tpu.ops import packing as jp
from bevy_ggrs_tpu_torch import GgrsRunner, SyncTestSession
from bevy_ggrs_tpu_torch.models import fixed_point, stress
from bevy_ggrs_tpu_torch.ops import packing as tp
from bevy_ggrs_tpu_torch.ops.packing import PackedUpload

SPECS = {  # players, input shape, dtype
    "scalar_uint8": (2, (), np.uint8),
    "vector_int16": (3, (4,), np.int16),
    "matrix_float32": (2, (2, 2), np.float32),
    "int64_scalar": (1, (), np.int64),  # width 16: rows 8-aligned
    "int64_pair": (2, (), np.int64),  # width 20: rows only 4-aligned
    "float64_vector": (3, (1,), np.float64),  # width 28: rows only 4-aligned
    "bool_vector": (2, (3,), np.bool_),
}


def seeded_rows(players, shape, dtype, k, rng):
    dtype = np.dtype(dtype)
    size = (k, players, *shape)
    if dtype == np.bool_:
        inputs = rng.integers(0, 2, size).astype(bool)
    elif np.issubdtype(dtype, np.floating):
        inputs = rng.standard_normal(size).astype(dtype)
    else:
        info = np.iinfo(dtype)
        inputs = rng.integers(info.min, info.max, size, dtype=dtype, endpoint=True)
    status = rng.integers(0, 3, (k, players), dtype=np.int8)
    return inputs, status


def pack_both(name, k, k_pad, start, has_load=0, load_slot=0, seed=0):
    players, shape, dtype = SPECS[name]
    inputs, status = seeded_rows(players, shape, dtype, k, np.random.default_rng(seed))
    bufs = []
    for mod in (jp, tp):
        spec = mod.PackedSpec.from_parts(players, shape, dtype)
        buf = spec.new_buffer(k_pad)
        mod.pack_prefix(buf, start, k, has_load, load_slot)
        for i in range(k):
            mod.pack_row(spec, buf, i, inputs[i], status[i])
        mod.repeat_last_row(buf, k, k_pad)
        bufs.append((spec, buf))
    return bufs, inputs, status


@pytest.mark.parametrize("name", list(SPECS))
@pytest.mark.parametrize("k,k_pad,start", [(5, 5, 1234), (3, 8, -7), (1, 1, -2**31)])
def test_packed_bytes_equal_jax_and_unpack_round_trips(name, k, k_pad, start):
    ((jspec, jbuf), (tspec, tbuf)), inputs, status = pack_both(
        name, k, k_pad, start, has_load=1, load_slot=5)
    assert tspec.width == jspec.width and tspec.payload == jspec.payload
    assert tbuf.dtype == jbuf.dtype and tbuf.tobytes() == jbuf.tobytes()
    assert tp.prefix_words(tbuf) == (start, k, 1, 5)
    tin, tst = tp.unpack_seq(tspec, torch.from_numpy(tbuf))
    assert tin.dtype == tp.torch_dtype(jspec.input_dtype)
    assert tst.dtype == torch.int8
    want_in = np.concatenate([inputs, np.repeat(inputs[-1:], k_pad - k, 0)])
    want_st = np.concatenate([status, np.repeat(status[-1:], k_pad - k, 0)])
    np.testing.assert_array_equal(tin.numpy(), want_in)
    np.testing.assert_array_equal(tst.numpy(), want_st)
    # JAX's split runs here without 64-bit types and takes no bool inputs
    if jspec.input_dtype.itemsize <= 4 and jspec.input_dtype != np.bool_:
        jin, jst, jstart, jn, jhl, jls = jax.jit(lambda p: jp.unpack_seq(jspec, p))(jbuf)
        assert (int(jstart), int(jn), int(jhl), int(jls)) == tp.prefix_words(tbuf)
        np.testing.assert_array_equal(tin.numpy(), np.asarray(jin))
        np.testing.assert_array_equal(tst.numpy(), np.asarray(jst))


def test_unpack_of_unaligned_rows_copies_and_aligned_rows_view():
    """8-byte inputs in 20-byte rows cannot be viewed in place: the split
    copies them; in 16-byte rows, and uint8 inputs in any rows, the split
    is a view of the upload."""
    for name, width, view in (("int64_pair", 20, False), ("int64_scalar", 16, True),
                              ("scalar_uint8", 16, True)):
        (_, _), (spec, buf) = pack_both(name, 3, 3, 0)[0]
        rows = torch.from_numpy(buf)
        inputs, status = tp.unpack_seq(spec, rows)
        base = rows.untyped_storage().data_ptr()
        assert spec.width == width
        assert (inputs.untyped_storage().data_ptr() == base) == view, name
        assert status.untyped_storage().data_ptr() == base


def test_repeat_last_row_pads_with_final_real_row():
    spec = tp.PackedSpec.from_parts(2, (), np.uint8)
    buf = spec.new_buffer(6)
    for i in range(3):
        tp.pack_row(spec, buf, i, np.full(2, 10 + i, np.uint8), np.zeros(2, np.int8))
    tp.repeat_last_row(buf, 3, 6)
    for row in range(4, 7):  # padded payload rows 3..5 live at indices 4..6
        np.testing.assert_array_equal(buf[row], buf[3])


def test_width_is_prefix_and_word_aligned():
    spec = tp.PackedSpec.from_parts(1, (), np.uint8)  # payload 2 < prefix 16
    assert spec.width >= tp.PREFIX_BYTES and spec.width % 4 == 0
    big = tp.PackedSpec.from_parts(4, (5,), np.float32)  # payload 84
    assert big.width == 84


def test_packed_resim_equals_jax_packed_program():
    """The port's packed resim on the port's bytes equals the JAX packed
    program on the JAX bytes (fixed_point: integer state, exact)."""
    k, start = 6, 0
    (jspec, jbuf), (tspec, tbuf) = pack_both("scalar_uint8", k, k, start, seed=4)[0]
    tbuf[1:, :2] &= 0xF  # fixed_point reads a 4-bit pad
    jbuf[1:, :2] &= 0xF
    japp, tapp = j_fixed_point.make_app(), fixed_point.make_app(device="cpu")
    _, _, jchecks = japp.packed_resim_fn(japp.init_state(), jbuf)
    packed = PackedUpload(torch.from_numpy(tbuf), *tp.prefix_words(tbuf))
    _, _, tchecks = tapp.packed_resim_fn(tapp.init_state(), packed)
    np.testing.assert_array_equal(tchecks.numpy(), np.asarray(jchecks).astype(np.int64))


# -- the runner: packed == two uploads ---------------------------------------


def synctest_runner(app, ticks=36, jax_runner=False, **kw):
    t = [0]

    def read_inputs(handles):
        t[0] += 1
        return {h: np.uint8((t[0] * 7 + h * 3) & 0xF) for h in handles}

    cls, sess = (JRunner, JSession) if jax_runner else (GgrsRunner, SyncTestSession)
    runner = cls(app, sess(num_players=2, input_shape=(), input_dtype=np.uint8,
                           check_distance=3, compare_interval=1),
                 read_inputs=read_inputs,
                 on_mismatch=lambda e: (_ for _ in ()).throw(e), **kw)
    stream = []
    for _ in range(ticks):
        runner.tick()
        stream.append(runner.checksum)
    runner.finish()
    return runner, stream


def ring_checksums(runner):
    return {f: int(runner.ring.peek(f)[1]()) for f in runner.ring.frames()}


def test_packed_solo_bit_identical_to_unpacked_and_to_jax():
    packed, ps = synctest_runner(fixed_point.make_app(device="cpu"), packed=True)
    plain, us = synctest_runner(fixed_point.make_app(device="cpu"), packed=False)
    _, js = synctest_runner(j_fixed_point.make_app(), jax_runner=True, pipeline=False)
    assert packed.packed and not plain.packed
    assert ps == us == js
    assert packed.frame == plain.frame
    assert ring_checksums(packed) == ring_checksums(plain)


def test_packed_upload_census_one_per_dispatch():
    packed, _ = synctest_runner(fixed_point.make_app(device="cpu"), packed=True)
    st = packed.stats()
    # the tentpole invariant: every resim fed by exactly one upload of its
    # k + 1 rows (sum of k = dispatches + resimulated frames)
    assert st["host_uploads"] == st["device_dispatches"] > 0
    rows = 2 * st["device_dispatches"] + st["resimulated_frames"]
    assert st["packed_upload_bytes"] == rows * packed.app.packed_spec.width
    plain, _ = synctest_runner(fixed_point.make_app(device="cpu"), packed=False)
    stp = plain.stats()
    # the two-upload path: inputs and statuses (the start frame is a host int)
    assert stp["host_uploads"] == 2 * stp["device_dispatches"]
    assert stp["packed_upload_bytes"] == 0


def test_packed_canonical_bit_identical():
    def make():
        return stress.make_app(64, capacity=64, canonical_depth=8, device="cpu")

    packed, ps = synctest_runner(make(), packed=True)
    plain, us = synctest_runner(make(), packed=False)
    assert packed.packed
    assert ps == us
    assert ring_checksums(packed) == ring_checksums(plain)
    st = packed.stats()
    assert st["host_uploads"] == st["device_dispatches"]
    # every canonical upload carries canonical_depth payload rows
    assert st["packed_upload_bytes"] == st["device_dispatches"] * 9 * packed.app.packed_spec.width


def test_packed_mode_matrix_without_packed_program():
    """An app with no packed program: packed=None falls back to the two
    uploads, an explicit packed=True raises, and input_queue needs the
    packed path."""
    app = fixed_point.make_app(device="cpu")
    app.packed_resim_fn = None
    runner, _ = synctest_runner(app, packed=None, ticks=12)
    assert runner.packed is False
    assert runner.stats()["host_uploads"] == 2 * runner.stats()["device_dispatches"] > 0
    with pytest.raises(ValueError, match="packed program"):
        synctest_runner(app, packed=True, ticks=0)
    with pytest.raises(ValueError, match="input_queue"):
        synctest_runner(fixed_point.make_app(device="cpu"), packed=False,
                        input_queue=True, ticks=0)


def test_input_queue_rotation_bit_identical():
    queued, qs = synctest_runner(fixed_point.make_app(device="cpu"), input_queue=True)
    plain, us = synctest_runner(fixed_point.make_app(device="cpu"), packed=False)
    assert qs == us
    st = queued.stats()
    assert st["input_queue"] and st["host_uploads"] == st["device_dispatches"]
    assert st["staging_deferred_blocks"] == 0  # CPU copies land at once
    # every acquire but the first of each buffer found the last upload
    # landed (the queue regrows, with fresh buffers, as deeper runs appear)
    assert st["device_dispatches"] - 5 <= st["staging_landed_free"] < st["device_dispatches"]
