"""Threefry-2x32 counter-based random numbers, bit for bit as ``jax.random``.

The JAX package draws its rollback-safe randomness from ``jax.random``
(the default threefry PRNG): ``StepCtx.rng_key`` is
``fold_in(PRNGKey(seed), uint32(frame))`` and the particles model spawns
from ``fold_in(PRNGKey(seed), rng_counter)`` split in two, one half per
``uniform`` draw.  That is XLA work, not a Pallas kernel, so the port
writes the same hash as torch ops.  It follows the variant JAX runs with
``jax_threefry_partitionable=True`` (the default since jax 0.5):

- ``split(key, n)``: key ``i`` is ``threefry2x32(key, (0, i))``;
- ``random_bits(key, shape)``: element ``j`` (row-major) is
  ``y1 ^ y2`` of ``threefry2x32(key, (j >> 32, j & 0xFFFFFFFF))``;
- ``fold_in(key, d)``: ``threefry2x32(key, (0, uint32(d)))``;
- ``PRNGKey(seed)``: ``(seed >> 32, seed & 0xFFFFFFFF)``; the JAX package
  runs without x64, where a seed keeps only its low word, so the high word
  is 0 (``PRNGKey(-1)`` is ``(0, 0xFFFFFFFF)``);
- ``uniform``: ``bits >> 9 | 0x3F800000`` viewed as float32, less 1,
  scaled by ``maxval - minval``, plus ``minval``, then ``max`` with
  ``minval`` (``jax/_src/random.py`` ``_uniform``).

Words are u32 values held in int64 tensors in ``[0, 2**32)`` (torch on the
CPU has no uint32 shift or add), one code path on the CPU and the card.
A key is a pair of Python ints when everything it came from was a host
value (``PRNGKey(seed)``, a solo frame's ``fold_in``: no launch at all),
else an int64 tensor ``[..., 2]`` on the device of the data it was folded
with.  Every function batches under ``torch.func.vmap`` and reads nothing
back to the host.
"""

from __future__ import annotations

from math import prod
from typing import Sequence, Tuple, Union

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

Word = Union[int, torch.Tensor]
Key = Union[Tuple[int, int], torch.Tensor]


def _shl(x: Word, r: int) -> Word:
    """``x << r``; a tensor shifts through ``torch.bitwise_left_shift``,
    which a DTensor computes (its ``<<`` operator returns the input
    unchanged), with the same kernel as the operator on a plain tensor."""
    return torch.bitwise_left_shift(x, r) if isinstance(x, torch.Tensor) else x << r


def _shr(x: Word, r: int) -> Word:
    """``x >> r`` (see :func:`_shl`)."""
    return torch.bitwise_right_shift(x, r) if isinstance(x, torch.Tensor) else x >> r


def _rotl(x: Word, r: int) -> Word:
    return (_shl(x, r) | _shr(x, 32 - r)) & MASK32


def threefry2x32(k1: Word, k2: Word, x1: Word, x2: Word) -> Tuple[Word, Word]:
    """The Threefry-2x32 hash (20 rounds) of the counter words ``(x1, x2)``
    under the key words ``(k1, k2)``; any argument may be a Python int or
    an int64 tensor of u32 values, and tensors broadcast."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x0 = (x1 + ks[0]) & MASK32
    x1 = (x2 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = x0 ^ _rotl(x1, r)
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x0, x1


def key_words(key: Key) -> Tuple[Word, Word]:
    """A key's two words (ints, or tensors of the key's leading shape)."""
    if isinstance(key, torch.Tensor):
        return key[..., 0], key[..., 1]
    return int(key[0]), int(key[1])


def _make_key(y1: Word, y2: Word) -> Key:
    if isinstance(y1, torch.Tensor) or isinstance(y2, torch.Tensor):
        ref = y1 if isinstance(y1, torch.Tensor) else y2
        y1, y2 = torch.broadcast_tensors(torch.as_tensor(y1, device=ref.device),
                                         torch.as_tensor(y2, device=ref.device))
        return torch.stack([y1, y2], dim=-1)
    return (y1, y2)


def as_u32(data) -> Word:
    """``uint32(data)``: an int (wrapped) or an integer tensor as int64 u32
    values (a uint32 tensor by its bits)."""
    if isinstance(data, torch.Tensor):
        if data.dtype == torch.uint32:
            data = data.view(torch.int32)
        return data.to(torch.int64) & MASK32
    return int(data) & MASK32


def prng_key(seed: int) -> Tuple[int, int]:
    """``jax.random.PRNGKey(seed)`` without x64: ``(0, seed mod 2**32)``."""
    return (0, int(seed) & MASK32)


def fold_in(key: Key, data) -> Key:
    """``jax.random.fold_in(key, data)``; ``data`` an int or an integer
    tensor (taken as ``uint32``), the result on its device."""
    k1, k2 = key_words(key)
    return _make_key(*threefry2x32(k1, k2, 0, as_u32(data)))


def _device(key: Key, device) -> torch.device:
    if isinstance(key, torch.Tensor):
        return key.device
    if device is None:
        raise ValueError("a key of host ints needs an explicit device")
    return torch.device(device)


def split(key: Key, num: int = 2) -> Key:
    """``jax.random.split(key, num)`` (partitionable): ``[num, 2]`` keys,
    or a tuple of ``num`` keys of host ints when ``key`` is one."""
    k1, k2 = key_words(key)
    if not isinstance(key, torch.Tensor):
        return tuple(_make_key(*threefry2x32(k1, k2, 0, i)) for i in range(num))
    counts = torch.arange(num, dtype=torch.int64, device=key.device)
    return _make_key(*threefry2x32(k1[..., None], k2[..., None], 0, counts))


def random_bits(key: Key, shape: Sequence[int], device=None) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)`` (partitionable) as int64 u32
    values of ``shape``; a key of ints draws on ``device``."""
    shape = tuple(shape)
    n = prod(shape)
    if n >= 1 << 32:
        raise NotImplementedError("random_bits draws fewer than 2**32 values")
    counts = torch.arange(n, dtype=torch.int64, device=_device(key, device))
    k1, k2 = key_words(key)
    y1, y2 = threefry2x32(k1, k2, 0, counts)
    return (y1 ^ y2).reshape(shape)


def uniform(key: Key, shape: Sequence[int], minval: float = 0.0, maxval: float = 1.0,
            device=None) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``: float32
    in ``[minval, maxval)``."""
    bits = random_bits(key, shape, device)
    floats = (_shr(bits, 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo, hi = np.float32(minval), np.float32(maxval)
    return torch.clamp_min(floats * (hi - lo) + lo, float(lo))
