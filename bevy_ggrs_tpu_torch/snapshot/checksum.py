"""Deterministic world checksums as integer tensor ops.

Port of ``bevy_ggrs_tpu/snapshot/checksum.py``, bit for bit: the same
murmur3-style fold over each entity row's bit pattern (two independent
32-bit streams give one 64-bit checksum), masked by liveness, summed over
entities with wrapping u32 addition, re-hashed with a per-type tag and
XOR-combined across types.  Identical state bits give identical checksums
in both packages and on every device.

u32 values are held in int64 tensors in ``[0, 2**32)`` (torch on the CPU
has no uint32 shift, sum or compare).  The whole pass but the resource
parts — the per-entity fold and masked sum of the components, the work of
the removed TPU kernel, with the type tags, the entity part and the XOR
across them — runs through :func:`..ops.checksum_fold.checksum_fold`: the
CUDA kernel for a world on the card, its plain version for a world on the
CPU.

Every function here that takes a ``stacked`` world expects a leading frame
axis on every leaf (a resim's stacked output); the single-world functions
add that axis and drop it again.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Sequence, Tuple

import torch

from ..ops.checksum_fold import MASK32, _fold_rows, checksum_fold, fmix32, mix32
from ..utils.tree import tree_leaves, tree_map
from .world import Registry, WorldState

__all__ = [
    "MASK32", "mix32", "fmix32", "_fold_rows", "to_u32_lanes", "fold_inputs",
    "component_parts", "component_part",
    "resource_part", "entity_part", "world_checksum", "world_checksums",
    "branch_checksums",
    "checksum_to_int",
]

_SEED_HI = 0x9E3779B9
_SEED_LO = 0x85EBCA6B
SEEDS = (_SEED_HI, _SEED_LO)


def _i32_lanes(arr: torch.Tensor, lead: int) -> torch.Tensor:
    """Bit-cast ``[*lead_dims, ...]`` -> int32 ``[*lead_dims, L]`` holding
    the u32 lanes of each row, dtype by dtype as the JAX package's
    ``to_u32_lanes`` lays them out (64-bit values: all low words, then all
    high words)."""
    flat = arr.reshape(*arr.shape[:lead], -1)
    dt = flat.dtype
    if dt in (torch.float32, torch.int32, torch.uint32):
        return flat.contiguous().view(torch.int32)
    if dt in (torch.bfloat16, torch.float16, torch.uint16):
        return flat.contiguous().view(torch.int16).to(torch.int32) & 0xFFFF
    if dt in (torch.float64, torch.int64, torch.uint64):
        m = flat.shape[-1]
        words = flat.contiguous().view(torch.int32).reshape(*flat.shape[:-1], m, 2)
        return words.transpose(-1, -2).reshape(*flat.shape[:-1], 2 * m).contiguous()
    # bool / int8 / uint8 / int16: widen exactly (sign-extending signed types)
    return flat.to(torch.int32)


def _u32_bits(x: torch.Tensor) -> torch.Tensor:
    """``x.astype(uint32)`` as int32 bits; custom hash functions should
    return integer lanes (floats truncate toward zero)."""
    if x.dtype == torch.uint32:
        return x.view(torch.int32)
    if x.dtype.is_floating_point:
        x = x.to(torch.int64)
    return x.to(torch.int32)


def to_u32_lanes(arr: torch.Tensor) -> torch.Tensor:
    """Bit-cast ``[N, ...]`` -> ``[N, L]`` u32 lanes (int64, dtype-aware)."""
    return _i32_lanes(arr, 1).to(torch.int64) & MASK32


@lru_cache(maxsize=4096)
def _type_tag(name: str, seed: int) -> int:
    """Stable tag per registered type name (FNV-1a over utf-8)."""
    h = 0x811C9DC5 ^ (seed & MASK32)
    for b in name.encode():
        h = ((h ^ b) * 0x01000193) & MASK32
    return h


def _u32(x: torch.Tensor) -> torch.Tensor:
    """Integer tensor -> its u32 value in int64 (``astype(uint32)``)."""
    return x.to(torch.int64) & MASK32


def _stack1(w: WorldState) -> WorldState:
    return tree_map(lambda a: a.unsqueeze(0), w)


def _component_lanes(reg: Registry, stacked: WorldState, name: str) -> torch.Tensor:
    """int32 ``[k, N, L]`` lanes of one component over the stacked frames."""
    spec = reg.components[name]
    col = stacked.comps[name]
    if spec.hash_fn is None:
        return _i32_lanes(col, 2)
    rows = []
    for f in range(col.shape[0]):  # the hash sees one frame's column, as in JAX
        lanes = spec.hash_fn(col[f])
        rows.append(_u32_bits(lanes[:, None] if lanes.dim() == 1 else lanes))
    return torch.stack(rows).contiguous()


def fold_inputs(reg: Registry, stacked: WorldState, names: Sequence[str],
                seeds: Tuple[int, int] = SEEDS) -> tuple:
    """The :func:`checksum_fold` arguments for components ``names`` of a
    stacked world: lanes, presence masks, ids, liveness masks, component
    tags, ``next_id`` and entity tags.  Nothing here launches a kernel or
    copies to the device for columns whose lanes are a view (32-bit
    dtypes without a custom hash)."""
    return (
        [_component_lanes(reg, stacked, n) for n in names],
        [stacked.has[n].contiguous() for n in names],
        stacked.rollback_id.contiguous(),
        stacked.alive.contiguous(),
        stacked.despawn_pending.contiguous(),
        [(_type_tag(n, seeds[0]), _type_tag(n, seeds[1])) for n in names],
        stacked.next_id.contiguous(),
        (_type_tag("__entities__", seeds[0]), _type_tag("__entities__", seeds[1])),
    )


def component_parts(
    reg: Registry, stacked: WorldState, names: Sequence[str],
    seeds: Tuple[int, int] = SEEDS,
) -> torch.Tensor:
    """Checksum parts ``[k, C, 2]`` (u32 in int64) of components ``names``
    for both seeds — one :func:`checksum_fold` call over all of them."""
    return checksum_fold(*fold_inputs(reg, stacked, names, seeds))[:, 1:]


def component_part(reg: Registry, w: WorldState, name: str, seed: int) -> torch.Tensor:
    """Checksum part for one component type (u32 scalar in int64).

    Per entity: mix(row bits, stable id); masked wrapping sum over
    entities; re-hash with the type tag."""
    return component_parts(reg, _stack1(w), [name], (seed, seed))[0, 0, 0]


def _resource_lanes(reg: Registry, stacked: WorldState, name: str) -> torch.Tensor:
    spec = reg.resources[name]
    value = stacked.res[name]
    k = stacked.alive.shape[0]
    if spec.hash_fn is not None:
        return torch.stack([
            _u32(_u32_bits(spec.hash_fn(tree_map(lambda a: a[f], value)).reshape(-1)))
            for f in range(k)
        ])
    return torch.cat([_u32(_i32_lanes(x, 1)) for x in tree_leaves(value)], dim=1)


def _resource_parts(reg: Registry, stacked: WorldState, name: str,
                    seed: int) -> torch.Tensor:
    """``[k]`` checksum parts of one resource; presence participates."""
    tag = _type_tag("res:" + name, seed)
    lanes = _resource_lanes(reg, stacked, name)
    present = stacked.res_present[name]
    h = mix32(torch.full_like(present, tag, dtype=torch.int64), _u32(present))
    present_h = h
    for i in range(lanes.shape[1]):
        present_h = mix32(present_h, lanes[:, i])
    return fmix32(torch.where(present, present_h, h) ^ tag)


def resource_part(reg: Registry, w: WorldState, name: str, seed: int) -> torch.Tensor:
    """Checksum part for one resource (u32 scalar in int64)."""
    return _resource_parts(reg, _stack1(w), name, seed)[0]


def entity_part(w: WorldState, seed: int) -> torch.Tensor:
    """Hash of (active entity count, total ever spawned) — catches
    spawn/despawn divergence with no registered types."""
    return checksum_fold(*fold_inputs(None, _stack1(w), [], (seed, seed)))[0, 0, 0]


def world_checksums(reg: Registry, stacked: WorldState) -> torch.Tensor:
    """Checksums ``[k, 2]`` (hi, lo; u32 in int64) of every stacked frame.

    The one pass over a resim's stacked output: a single
    :func:`checksum_fold` call computes the entity part and every
    checksummed component's part; a checksummed resource's part, where the
    registry has one, is XORed in with small tensor ops."""
    names = [n for n, s in reg.components.items() if s.checksum]
    out = checksum_fold(*fold_inputs(reg, stacked, names))[:, 0]
    for name, spec in reg.resources.items():
        if spec.checksum:
            out = out ^ torch.stack(
                [_resource_parts(reg, stacked, name, seed) for seed in SEEDS], dim=-1)
    return out


def branch_checksums(reg: Registry, stacked_b: WorldState) -> torch.Tensor:
    """Checksums ``[M, k, 2]`` of a branch-stacked ``[M, k, ...]`` world:
    every leaf viewed as ``[M * k, ...]`` (a view of a contiguous stack),
    one :func:`world_checksums` pass, the result viewed as ``[M, k, 2]`` —
    one fold launch for all the lanes' frames."""
    m, k = stacked_b.alive.shape[:2]
    flat = tree_map(lambda a: a.reshape(m * k, *a.shape[2:]), stacked_b)
    return world_checksums(reg, flat).view(m, k, 2)


def world_checksum(reg: Registry, w: WorldState) -> torch.Tensor:
    """Full checksum -> ``[2]`` (hi, lo) u32 values in an int64 tensor;
    :func:`checksum_to_int` gives the 64-bit cross-peer value."""
    return world_checksums(reg, _stack1(w))[0]


def checksum_to_int(cs) -> int:
    """``[2]`` (hi, lo) checksum (tensor, array or sequence) -> python int."""
    hi, lo = (cs.tolist() if hasattr(cs, "tolist") else list(cs))
    return ((int(hi) & MASK32) << 32) | (int(lo) & MASK32)
