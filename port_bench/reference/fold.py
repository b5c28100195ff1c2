"""The world checksum in plain PyTorch, from its semantics.

A world's 64-bit checksum is two independent 32-bit streams (seeds
``0x9E3779B9``, the high word, and ``0x85EBCA6B``, the low word).  Per
stream, each checksummed component (in registration order) contributes
``fmix32(S ^ tag)``, where ``tag`` is FNV-1a of the component's name from
``0x811C9DC5 ^ seed`` and ``S`` the wrapping u32 sum, over live entities,
of ``fmix32(mix32(fmix32(mix32(tag, lane) ^ L), id))`` (murmur3's round and
finalizer; ``lane`` the float's bits, ``L = 1`` lane per float, ``id`` the
entity's stable id).  The entity part ``fmix32(mix32(mix32(etag, count),
next_id))``, with ``etag`` the tag of ``"__entities__"``, is XORed with
every component's contribution.

u32 values are held in int64 tensors; a product by a 32-bit constant is
taken in 16-bit halves so that no int64 product overflows.  The
benchmark's worlds hold ``n`` live entities with ids ``0..n-1`` in row
order and ``next_id = n``, and no resource.
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
SEED_HI = 0x9E3779B9
SEED_LO = 0x85EBCA6B


def tag(name: str, seed: int) -> int:
    """FNV-1a over the name's utf-8 bytes, from ``0x811C9DC5 ^ seed``."""
    h = 0x811C9DC5 ^ (seed & MASK32)
    for b in name.encode():
        h = ((h ^ b) * 0x01000193) & MASK32
    return h


def _mul(x: torch.Tensor, c: int) -> torch.Tensor:
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & MASK32) | (x >> (32 - r))


def mix32(h, k):
    k = _mul(k, 0xCC9E2D51)
    k = _rotl(k, 15)
    k = _mul(k, 0x1B873593)
    h = _rotl(h ^ k, 13)
    return (_mul(h, 5) + 0xE6546B64) & MASK32


def fmix32(h):
    h = h ^ (h >> 16)
    h = _mul(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def _const(value: int, like: torch.Tensor) -> torch.Tensor:
    return torch.full(like.shape, value, dtype=torch.int64, device=like.device)


def checksums(cols: dict, names) -> list:
    """The 64-bit checksum of each world in ``cols`` (name -> float32
    ``[W, N]``, every entity live): a list of ``W`` Python ints."""
    first = cols[names[0]]
    w, n = first.shape
    ids = torch.arange(n, dtype=torch.int64, device=first.device).expand(w, n)
    words = []
    for seed in (SEED_HI, SEED_LO):
        h = None
        parts = []
        for name in names:
            t = tag(name, seed)
            lane = cols[name].contiguous().view(torch.int32).to(torch.int64) & MASK32
            row = fmix32(mix32(_const(t, lane), lane) ^ 1)
            row = fmix32(mix32(row, ids))
            parts.append(fmix32((row.sum(-1) & MASK32) ^ t))
        count = next_id = _const(n, parts[0])
        h = fmix32(mix32(mix32(_const(tag("__entities__", seed), count), count), next_id))
        for p in parts:
            h = h ^ p
        words.append(h)
    hi, lo = (x.tolist() for x in words)
    return [((a & MASK32) << 32) | (b & MASK32) for a, b in zip(hi, lo)]
