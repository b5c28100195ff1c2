"""Columnar SoA world state and registry, on torch tensors.

Port of ``bevy_ggrs_tpu/snapshot/world.py``.  Every registered component is
a fixed-capacity column ``[capacity, *shape]``; entity identity is (slot,
rollback_id); a snapshot is the whole :class:`WorldState`.  Restoring a
snapshot restores the allocator, ids, masks and columns at once, so
respawning with the same id and remapping entity references need no code.

The leaves, dtypes and shapes are those of the JAX package's world, leaf
for leaf, so a world carries across with :mod:`..convert` and checksums to
the same bits.  The functions here are pure: they return new tensors and
never write into their inputs, because a saved snapshot may share tensors
with the live world.

Invariants kept from the reference (bevy_ggrs):

- ``rollback_id`` is assigned once per logical entity, in spawn order;
- despawn is deferred until the frame is confirmed
  (:func:`despawn_confirmed`); marked entities leave :func:`active_mask`
  at once;
- spawn order is deterministic: first free slot, ids in call order.

The hierarchy (``Registry.register_hierarchy``) is one int32 column of
parent slot indices; since a snapshot restores the allocator wholesale,
slots are stable and no parent remap is needed on rollback.
:func:`despawn_recursive` marks a subtree with a loop whose length is
fixed by the capacity (pointer jumping), so it reads nothing back to the
host and batches under ``torch.func.vmap``.

Every write at a slot (``spawn``, ``despawn``, ``insert_component``,
``remove_component``) is a select against ``arange(capacity) == slot``,
not an index write, so a per-lane slot batches under ``vmap`` (the
many-worlds lanes of ``ops/batch.py``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..utils.device import DeviceLike, resolve_device
from ..utils.tree import tree_map
from .strategy import CopyStrategy, Strategy


def as_torch_dtype(dtype: Any) -> torch.dtype:
    """A torch dtype from a torch dtype, a numpy dtype or a numpy type."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, np.dtype(dtype).name)


def _to_tensor(value: Any, dtype: torch.dtype, device) -> torch.Tensor:
    """``value`` as a tensor of ``dtype`` on ``device`` (a copy if needed)."""
    if isinstance(value, torch.Tensor):
        return value.to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(value), device=device).to(dtype)


_SIGNED = {torch.uint16: torch.int16, torch.uint32: torch.int32,
           torch.uint64: torch.int64}


def _bits(t: torch.Tensor) -> torch.Tensor:
    """A same-width signed view of an unsigned tensor (CUDA has no indexing
    or ``where`` kernels for uint16/32/64); other tensors as they are."""
    return t.view(_SIGNED[t.dtype]) if t.dtype in _SIGNED else t


def _resource_leaf(value: Any) -> torch.Tensor:
    """A registered resource leaf as a CPU tensor.  Python scalars take the
    JAX package's default widths (int32, float32), not torch's."""
    if isinstance(value, torch.Tensor):
        return value.detach().clone()
    if isinstance(value, bool):
        return torch.tensor(value)
    if isinstance(value, int):
        return torch.tensor(value, dtype=torch.int32)
    if isinstance(value, float):
        return torch.tensor(value, dtype=torch.float32)
    return torch.as_tensor(np.array(value))


@dataclass
class WorldState:
    """The complete rollback-visible simulation state (a tree of tensors).

    Everything here is restored wholesale on rollback.  A stacked resim
    output is a ``WorldState`` too, with a leading frame axis on every
    leaf."""

    comps: Dict[str, torch.Tensor]  # name -> [capacity, *shape]
    has: Dict[str, torch.Tensor]  # name -> bool[capacity]
    res: Dict[str, Any]  # resource name -> tree of tensors
    res_present: Dict[str, torch.Tensor]  # name -> bool scalar
    alive: torch.Tensor  # bool[capacity]
    rollback_id: torch.Tensor  # int32[capacity]; -1 = free slot
    despawn_pending: torch.Tensor  # bool[capacity]
    despawn_frame: torch.Tensor  # int32[capacity] (valid iff pending)
    next_id: torch.Tensor  # int32 scalar: total entities ever spawned
    overflow: torch.Tensor  # bool scalar: a spawn found no free slot

    @property
    def device(self) -> torch.device:
        return self.alive.device


def active_mask(w: WorldState) -> torch.Tensor:
    """Alive and not marked for deferred despawn — what queries see."""
    return w.alive & ~w.despawn_pending


@dataclass(frozen=True)
class ComponentSpec:
    """Static registration record for one component column."""
    name: str
    shape: Tuple[int, ...]
    dtype: torch.dtype
    default: torch.Tensor  # CPU tensor of ``shape``
    checksum: bool
    hash_fn: Optional[Callable[[torch.Tensor], torch.Tensor]]
    strategy: Strategy
    required: bool  # inserted on every spawn


@dataclass(frozen=True)
class ResourceSpec:
    """Static registration record for one resource."""
    name: str
    init: Any  # tree of CPU tensors
    checksum: bool
    hash_fn: Optional[Callable[[Any], torch.Tensor]]
    present: bool
    strategy: Strategy


class Registry:
    """Host-side static registration of rollback state (the ``RollbackApp``
    surface): components and resources opt in to snapshots, checksums
    (optionally with a custom hash) and a store/load strategy."""

    PARENT = "child_of"  # reserved hierarchy component (ChildOf analog)

    def __init__(self, capacity: int):
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        self.capacity = capacity
        self.components: Dict[str, ComponentSpec] = {}
        self.resources: Dict[str, ResourceSpec] = {}

    # -- registration ------------------------------------------------------

    def register_component(
        self,
        name: str,
        shape: Tuple[int, ...] = (),
        dtype: Any = torch.float32,
        default: Any = None,
        checksum: bool = False,
        hash_fn: Optional[Callable] = None,
        strategy: Strategy = CopyStrategy,
        required: bool = False,
    ) -> "Registry":
        """Register a fixed-shape component column."""
        if name in self.components:
            raise ValueError(f"component {name!r} already registered")
        dtype = as_torch_dtype(dtype)
        if default is None:
            default = torch.zeros(tuple(shape), dtype=dtype)
        else:
            default = _to_tensor(default, dtype, "cpu")
            if tuple(default.shape) != tuple(shape):
                raise ValueError(
                    f"default for {name!r} has shape {tuple(default.shape)}, "
                    f"want {tuple(shape)}"
                )
        self.components[name] = ComponentSpec(
            name, tuple(shape), dtype, default, checksum, hash_fn, strategy, required
        )
        return self

    def register_hierarchy(self) -> "Registry":
        """Register the parent-link component (``ChildOf`` analog): an
        int32 parent slot per entity, -1 for none, checksummed."""
        return self.register_component(
            self.PARENT, (), torch.int32, default=-1, checksum=True
        )

    @property
    def has_hierarchy(self) -> bool:
        return self.PARENT in self.components

    def register_resource(
        self,
        name: str,
        init: Any,
        checksum: bool = False,
        hash_fn: Optional[Callable] = None,
        present: bool = True,
        strategy: Strategy = CopyStrategy,
    ) -> "Registry":
        """Register a resource (a tree of tensors, with optional absence)."""
        if name in self.resources:
            raise ValueError(f"resource {name!r} already registered")
        self.resources[name] = ResourceSpec(
            name, tree_map(_resource_leaf, init), checksum, hash_fn, present,
            strategy,
        )
        return self

    # -- state construction ------------------------------------------------

    def init_state(self, device: DeviceLike = None) -> WorldState:
        """Allocate the empty world on ``device`` (``None`` = CUDA)."""
        dev = resolve_device(device)
        cap = self.capacity
        comps = {
            n: s.default.to(dev).expand(cap, *s.shape).contiguous()
            for n, s in self.components.items()
        }
        return WorldState(
            comps=comps,
            has={n: torch.zeros(cap, dtype=torch.bool, device=dev)
                 for n in self.components},
            res={n: tree_map(lambda x: x.to(dev, copy=True), s.init)
                 for n, s in self.resources.items()},
            res_present={n: torch.tensor(s.present, device=dev)
                         for n, s in self.resources.items()},
            alive=torch.zeros(cap, dtype=torch.bool, device=dev),
            rollback_id=torch.full((cap,), -1, dtype=torch.int32, device=dev),
            despawn_pending=torch.zeros(cap, dtype=torch.bool, device=dev),
            despawn_frame=torch.zeros(cap, dtype=torch.int32, device=dev),
            next_id=torch.tensor(0, dtype=torch.int32, device=dev),
            overflow=torch.tensor(False, device=dev),
        )

    # -- snapshot strategies ----------------------------------------------

    def store_state(self, w: WorldState) -> WorldState:
        """Apply per-type store strategies before a snapshot is retained."""
        comps = dict(w.comps)
        for n, s in self.components.items():
            if s.strategy.store is not None:
                comps[n] = s.strategy.store(comps[n])
        res = dict(w.res)
        for n, s in self.resources.items():
            if s.strategy.store is not None:
                res[n] = tree_map(s.strategy.store, res[n])
        return dataclasses.replace(w, comps=comps, res=res)

    def load_state(self, stored: WorldState) -> WorldState:
        """Inverse of :meth:`store_state`, applied when a snapshot is restored."""
        comps = dict(stored.comps)
        for n, s in self.components.items():
            if s.strategy.load is not None:
                comps[n] = s.strategy.load(comps[n]).to(s.dtype)
        res = dict(stored.res)
        for n, s in self.resources.items():
            if s.strategy.load is not None:
                res[n] = tree_map(s.strategy.load, res[n])
        return dataclasses.replace(stored, comps=comps, res=res)

    def is_identity_strategy(self) -> bool:
        return all(
            s.strategy.store is None and s.strategy.load is None
            for s in list(self.components.values()) + list(self.resources.values())
        )


# ---------------------------------------------------------------------------
# Entity operations (pure: inputs are never written)
# ---------------------------------------------------------------------------


def _scalar(value: Any, dtype: torch.dtype, device):
    """A Python scalar stays a kernel argument (no upload); anything else
    becomes a tensor of ``dtype`` on ``device``."""
    if isinstance(value, (bool, int, float)):
        return value
    return _to_tensor(value, dtype, device)


def slot_mask(capacity: int, slot, device) -> torch.Tensor:
    """``bool[capacity]`` true at ``slot`` only: the select that stands in
    for an index write.  Negative slots count from the end and a slot out
    of range selects nothing, as the JAX package's ``.at[slot].set`` does.
    A tensor ``slot`` (a device scalar, or a lane's under ``vmap``) is
    never read on the host."""
    idx = torch.arange(capacity, dtype=torch.int32, device=device)
    if isinstance(slot, torch.Tensor):
        slot = slot.to(device=device, dtype=torch.int32)
        return idx == torch.where(slot < 0, slot + capacity, slot)
    slot = int(slot)
    return idx == (slot + capacity if slot < 0 else slot)


def _put(arr: torch.Tensor, sel: torch.Tensor, value) -> torch.Tensor:
    """``arr`` with rows where ``sel`` holds set to ``value`` (a select)."""
    m = sel.reshape((-1,) + (1,) * (arr.dim() - 1))
    if isinstance(value, torch.Tensor):
        value = _bits(value)
    return torch.where(m, value, _bits(arr)).view(arr.dtype)


def spawn(
    reg: Registry, w: WorldState, comps: Optional[Dict[str, Any]] = None
) -> Tuple[WorldState, torch.Tensor]:
    """Spawn one entity in the first free slot; returns (world, slot).

    Assigns the next rollback id.  If the world is full nothing is written,
    the ``overflow`` flag is set and the returned slot is -1.  Runs without
    a host sync: the slot stays a device scalar."""
    comps = comps or {}
    unknown = set(comps) - set(reg.components)
    if unknown:
        raise KeyError(f"spawn with unregistered components: {sorted(unknown)}")
    dev = w.device
    free = ~w.alive
    any_free = free.any()
    slot = free.to(torch.int32).argmax()  # first free slot (0 when full)
    # a full world writes nothing: slot 0's live state stays intact
    sel = slot_mask(reg.capacity, slot, dev) & any_free

    new_comps = dict(w.comps)
    new_has = dict(w.has)
    for name, spec in reg.components.items():
        if name in comps:
            row = _to_tensor(comps[name], spec.dtype, dev)
            new_comps[name] = _put(new_comps[name], sel, row)
            new_has[name] = new_has[name] | sel
        elif spec.required:
            new_comps[name] = _put(new_comps[name], sel, spec.default.to(dev))
            new_has[name] = new_has[name] | sel
        else:
            new_has[name] = new_has[name] & ~sel
    world = dataclasses.replace(
        w,
        comps=new_comps,
        has=new_has,
        alive=w.alive | sel,
        rollback_id=torch.where(sel, w.next_id, w.rollback_id),
        despawn_pending=w.despawn_pending & ~sel,
        next_id=w.next_id + any_free.to(torch.int32),
        overflow=w.overflow | ~any_free,
    )
    return world, torch.where(any_free, slot.to(torch.int32), -1)


def spawn_many(
    reg: Registry, w: WorldState, comps: Dict[str, Any], count
) -> WorldState:
    """Spawn up to ``rows`` entities at once.

    ``comps`` maps names to ``[rows, *shape]`` values; ``count`` (<= rows)
    limits how many spawn.  Ids follow row order and slots ascend through
    the free slots, so the result is deterministic.  A Python int
    ``count`` stays a kernel argument (no upload); a tensor is never read
    on the host."""
    dev = w.device
    rows = next(iter(comps.values())).shape[0]
    if isinstance(count, torch.Tensor):
        count = torch.clamp(count.to(device=dev, dtype=torch.int32), max=rows)
    else:
        count = min(int(count), rows)
    free = ~w.alive
    rank = torch.cumsum(free.to(torch.int32), 0, dtype=torch.int32) - 1
    take = free & (rank < count)
    n_taken = take.sum().to(torch.int32)
    row_of_slot = torch.where(take, rank, 0)  # row feeding each taken slot
    new_comps = dict(w.comps)
    new_has = dict(w.has)
    for name, spec in reg.components.items():
        tk = take.reshape((-1,) + (1,) * len(spec.shape))
        if name in comps:
            src = _bits(_to_tensor(comps[name], spec.dtype, dev))[row_of_slot.long()]
            new_comps[name] = torch.where(tk, src, _bits(new_comps[name])).view(spec.dtype)
            new_has[name] = new_has[name] | take
        elif spec.required:
            new_comps[name] = torch.where(
                tk, _bits(spec.default.to(dev)), _bits(new_comps[name])
            ).view(spec.dtype)
            new_has[name] = new_has[name] | take
        else:
            new_has[name] = new_has[name] & ~take
    return dataclasses.replace(
        w,
        comps=new_comps,
        has=new_has,
        alive=w.alive | take,
        rollback_id=torch.where(take, w.next_id + row_of_slot, w.rollback_id),
        despawn_pending=w.despawn_pending & ~take,
        next_id=w.next_id + n_taken,
        overflow=w.overflow | (n_taken < count),
    )


def despawn(reg: Registry, w: WorldState, slot, frame) -> WorldState:
    """Mark ``slot`` for deferred despawn at ``frame``.

    The entity stays allocated, so a rollback to before ``frame`` revives
    it, but it leaves :func:`active_mask` at once."""
    sel = slot_mask(reg.capacity, slot, w.device)
    return dataclasses.replace(
        w,
        despawn_pending=w.despawn_pending | sel,
        despawn_frame=torch.where(sel, _scalar(frame, torch.int32, w.device),
                                  w.despawn_frame),
    )


def despawn_where(reg: Registry, w: WorldState, mask: torch.Tensor, frame) -> WorldState:
    """Deferred despawn of every alive slot where ``mask`` holds."""
    mask = mask & w.alive
    return dataclasses.replace(
        w,
        despawn_pending=w.despawn_pending | mask,
        despawn_frame=torch.where(
            mask, _scalar(frame, torch.int32, w.device), w.despawn_frame
        ),
    )


def despawn_recursive(reg: Registry, w: WorldState, slot, frame) -> WorldState:
    """Deferred despawn of ``slot`` and all its descendants (the JAX
    package's ``despawn_recursive``; plain :func:`despawn` without a
    hierarchy).

    An entity is marked when its parent chain reaches ``slot`` through
    links that are all valid (the entity alive, with a parent >= 0).  The
    JAX package iterates that to a fixpoint with ``lax.while_loop``, which
    here would read a flag back to the host every pass.  Instead pointer
    jumping doubles the followed chain length each round: after ``r``
    rounds ``hit[i]`` says whether ``slot`` lies within ``2**r`` valid
    links of ``i``, and ``ceil(log2(capacity))`` rounds cover every
    simple chain, so the loop's length is fixed by the capacity and the
    marks equal the fixpoint's bit for bit."""
    if not reg.has_hierarchy:
        return despawn(reg, w, slot, frame)
    cap = reg.capacity
    parent = w.comps[Registry.PARENT].to(torch.int32)
    valid = w.alive & w.has[Registry.PARENT] & (parent >= 0)  # link i -> parent
    ptr = torch.clamp(parent, 0, cap - 1).long()
    hit = slot_mask(cap, slot, w.device)
    for _ in range((cap - 1).bit_length()):
        hit = hit | (valid & hit[ptr])
        valid = valid & valid[ptr]
        ptr = ptr[ptr]
    return despawn_where(reg, w, hit, frame)


def despawn_confirmed(reg: Registry, w: WorldState, confirmed) -> WorldState:
    """Hard-free every slot whose despawn frame is confirmed (wrapping i32
    compare) — the reference's ``DespawnConfirmed`` pass.  A python int
    ``confirmed`` (in i32 range) stays a kernel argument: no upload."""
    if isinstance(confirmed, torch.Tensor):
        confirmed = confirmed.to(device=w.device, dtype=torch.int32)
    else:
        confirmed = int(confirmed)
    kill = w.despawn_pending & ((w.despawn_frame - confirmed) <= 0)
    return dataclasses.replace(
        w,
        has={n: h & ~kill for n, h in w.has.items()},
        alive=w.alive & ~kill,
        rollback_id=torch.where(kill, -1, w.rollback_id),
        despawn_pending=w.despawn_pending & ~kill,
    )


# -- component / resource presence ops --------------------------------------


def insert_component(
    reg: Registry, w: WorldState, slot, name: str, value
) -> WorldState:
    """Give ``slot`` the component ``name`` with ``value`` (presence set)."""
    spec = reg.components[name]
    sel = slot_mask(reg.capacity, slot, w.device)
    col = _put(w.comps[name], sel, _to_tensor(value, spec.dtype, w.device))
    return dataclasses.replace(
        w, comps={**w.comps, name: col}, has={**w.has, name: w.has[name] | sel}
    )


def remove_component(reg: Registry, w: WorldState, slot, name: str) -> WorldState:
    """Clear ``slot``'s presence of component ``name`` (value retained)."""
    sel = slot_mask(reg.capacity, slot, w.device)
    return dataclasses.replace(w, has={**w.has, name: w.has[name] & ~sel})


def insert_resource(reg: Registry, w: WorldState, name: str, value) -> WorldState:
    """Insert or overwrite a registered resource (present flag set)."""
    spec = reg.resources[name]
    value = tree_map(lambda v, i: _to_tensor(v, i.dtype, w.device), value, spec.init)
    return dataclasses.replace(
        w,
        res={**w.res, name: value},
        res_present={**w.res_present, name: torch.tensor(True, device=w.device)},
    )


def remove_resource(reg: Registry, w: WorldState, name: str) -> WorldState:
    """Mark a registered resource absent (value retained for restore)."""
    return dataclasses.replace(
        w,
        res_present={**w.res_present, name: torch.tensor(False, device=w.device)},
    )


def active_count(w: WorldState) -> torch.Tensor:
    """Number of alive, not-despawn-pending entities (int32 scalar)."""
    return active_mask(w).sum().to(torch.int32)
