"""Scaling past one device: the lobby mesh and the entity/branch mesh.

Port of ``bevy_ggrs_tpu/parallel/mesh.py``.  The JAX package has two
meshes, and torch, which has no single-controller global array, needs a
mechanism for each:

- **The lobby axis** (:func:`make_lobby_mesh`, :func:`shard_lobby_worlds`,
  ``ops/batch.ShardedWaveExecutor``, ``BatchedRunner(mesh=)``): many whole
  worlds split over devices in contiguous blocks.  Lobbies never
  communicate, so one process drives every device and there are no
  collectives.  A :class:`LobbyMesh` is an ordered list of devices under
  the axis name ``"lobby"``; a device may appear more than once ("logical
  shards": ``[cpu] * 8`` in the CPU tests, ``[cuda:0] * 4`` on one card),
  the port's counterpart of the JAX tests' eight virtual CPU devices.
- **The entity and branch axes** (:func:`make_mesh`, :func:`shard_world`,
  :func:`make_sharded_resim_fn`, :func:`make_sharded_speculate_fn`,
  :func:`make_sharded_canonical_fn`, ``multihost``): ONE world whose
  capacity axis is split over ``"data"`` and whose speculative branches
  split over ``"spec"``.  One ``torch.distributed`` rank per device, each
  running the same driver; the world is a DTensor over a ``DeviceMesh``
  (torch's counterpart of ``NamedSharding``), and a step's cross-entity
  operations (``spawn``'s cumsum and argmax, reductions) become DTensor
  collectives.  The checksum pass folds each rank's rows to slot sums,
  all-reduces them over ``"data"`` and finishes from the sums
  (``snapshot/checksum.py``); the slots are wrapping u32 sums, so the
  result equals the one-device checksum bit for bit.

Plain tensors inside a step (constants, Threefry draws, ``spawn_many``'s
row sources) are mixed with the sharded world under
``torch.distributed.tensor.experimental.implicit_replication``, which
treats them as replicated.  DTensor's ``<<`` and ``>>`` operators return
their input unchanged in the torch this was written against, so the
port's integer hashes shift with ``torch.bitwise_left_shift`` /
``bitwise_right_shift`` (``utils/threefry.py``); with that, the sharded
frames are the one-device frames bit for bit.

Nothing here imports ``torch.distributed.tensor`` (DTensor's machinery)
at module import: the entity half imports it when first called.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import ClassVar, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..app import App
from ..snapshot.lazy import LobbyShards
from ..snapshot.world import WorldState
from ..utils.device import is_dtensor, resolve_device
from ..utils.tree import tree_flatten, tree_map

DATA_AXIS = "data"
SPEC_AXIS = "spec"
LOBBY_AXIS = "lobby"


# -- the lobby axis ---------------------------------------------------------------


@dataclass(frozen=True)
class LobbyMesh:
    """An ordered list of devices over the ``"lobby"`` axis; shard ``d``
    runs on ``devices[d]`` (a device may hold several shards)."""

    devices: Tuple[torch.device, ...]
    axis_names: ClassVar[Tuple[str, ...]] = (LOBBY_AXIS,)

    @property
    def size(self) -> int:
        return len(self.devices)

    def shard_names(self) -> List[str]:
        """One label per shard: the device's name, with ``#d`` added when
        the mesh names a device more than once."""
        names = [str(d) for d in self.devices]
        if len(set(names)) == len(names):
            return names
        return [f"{n}#{d}" for d, n in enumerate(names)]


def make_lobby_mesh(n_devices: Optional[int] = None, devices=None) -> LobbyMesh:
    """1-D mesh over the ``"lobby"`` axis: the many-worlds scale-out shape
    (``ops/batch.ShardedWaveExecutor``), each shard a contiguous block of
    lobby lanes running the same wave program, with no collectives.

    ``devices`` defaults to every visible CUDA device (and raises without
    a card, as :func:`~..utils.device.resolve_device` does).  A caller may
    name one device more than once: ``[torch.device("cpu")] * 8`` gives
    eight logical shards of the CPU, ``["cuda:0"] * 4`` four of one card,
    which plays the role the JAX tests' virtual CPU devices play.
    ``n_devices`` keeps the first that many."""
    if devices is None:
        resolve_device(None)
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [resolve_device(d) for d in devices]
    if n_devices is None:
        n_devices = len(devices)
    if n_devices < 1:
        raise ValueError(f"lobby mesh needs >= 1 device, got {n_devices}")
    if n_devices > len(devices):
        raise ValueError(f"lobby mesh of {n_devices} devices, {len(devices)} given")
    return LobbyMesh(tuple(devices[:n_devices]))


@dataclass(frozen=True)
class LobbySharding:
    """Where a lobby lives on a lobby mesh: contiguous blocks of
    ``lanes = M / D`` lobbies, lobby ``b`` on shard ``b // lanes``, with the
    leading (lobby) axis of an ``ndim``-dimensional leaf split."""

    mesh: LobbyMesh
    ndim: int = 1  # the leaf rank, as in the JAX signature; only axis 0 splits

    def lanes(self, m: int) -> int:
        """Lobbies per shard of an ``m``-lobby wave (``m`` must divide)."""
        d = self.mesh.size
        if m % d:
            raise ValueError(f"{m} lobbies do not divide over {d} shards; pad them "
                             "(ShardedWaveExecutor.pad_lobbies)")
        return m // d

    def shard_of(self, b: int, m: int) -> int:
        """The shard holding lobby ``b`` of ``m``."""
        return b // self.lanes(m)


def lobby_sharding(mesh: LobbyMesh, ndim: int = 1) -> LobbySharding:
    """The sharding that splits the leading (lobby) axis over the mesh."""
    return LobbySharding(mesh, ndim)


def shard_lobby_worlds(mesh: LobbyMesh, worlds) -> LobbyShards:
    """Place a stacked ``[M, ...]`` many-worlds tree onto the lobby mesh:
    every leaf's leading axis split in contiguous blocks, shard ``d``'s on
    its device (M must divide by the shard count; the batched runner pads
    its resident world to ensure it)."""
    lanes = lobby_sharding(mesh).lanes(tree_flatten(worlds)[0].shape[0])
    return LobbyShards([tree_map(lambda a: a[d * lanes:(d + 1) * lanes].to(dev), worlds)
                        for d, dev in enumerate(mesh.devices)], lanes)


# -- the entity and branch axes ---------------------------------------------------


def _local_device(device_type: str) -> torch.device:
    if device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device_type)


def _device_type(devices) -> str:
    if devices is None:
        return resolve_device(None).type
    if isinstance(devices, (str, torch.device)):
        return resolve_device(devices).type
    types = {resolve_device(d).type for d in devices}
    if len(types) != 1:
        raise ValueError(f"a mesh takes one device type, got {sorted(types)}")
    return types.pop()


def ensure_process_group(device_type: str) -> None:
    """Start a one-rank group on a ``HashStore`` when this process has
    none (one process works as it does in JAX, with no port to open).
    The backend is NCCL for CUDA and gloo for the CPU, never switched."""
    if dist.is_initialized():
        return
    backend = "nccl" if device_type == "cuda" else "gloo"
    if device_type == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)


def _check_backend(device_type: str) -> None:
    backend = dist.get_backend()
    want = "nccl" if device_type == "cuda" else "gloo"
    if want not in str(backend):
        raise ValueError(f"a {device_type} mesh needs a {want} group, this process "
                         f"has {backend!r}")


def _device_mesh(device_type: str, grid: np.ndarray):
    return DeviceMesh(device_type, torch.as_tensor(grid), mesh_dim_names=(DATA_AXIS, SPEC_AXIS))


def make_mesh(n_data: Optional[int] = None, n_spec: int = 1, devices=None):
    """A ``(data x spec)`` ``DeviceMesh`` over this group's ranks, one rank
    per device, rank ``i * n_spec + j`` at ``(i, j)`` (the JAX layout).
    ``devices`` names the device type (``"cpu"``, ``"cuda"`` or a list of
    devices); the default is CUDA, which raises without a card.  A process
    with no group starts a one-rank group (:func:`ensure_process_group`)."""
    device_type = _device_type(devices)
    ensure_process_group(device_type)
    _check_backend(device_type)
    world = dist.get_world_size()
    if n_data is None:
        n_data = world // n_spec
    if n_data * n_spec != world:
        raise ValueError(f"a {n_data} x {n_spec} mesh needs {n_data * n_spec} ranks, "
                         f"the group has {world}")
    return _device_mesh(device_type, np.arange(world).reshape(n_data, n_spec))


def _placements(mesh, sharded: bool):
    """Placements over ``mesh``: the capacity axis split over ``"data"``
    (when ``sharded``), replicated over the other dims."""
    from torch.distributed.tensor import Replicate, Shard

    return [Shard(0) if sharded and n == DATA_AXIS else Replicate()
            for n in mesh.mesh_dim_names]


def world_sharding(reg, mesh, world: WorldState):
    """Placements per leaf: capacity-axis leaves split over ``"data"``,
    scalars and resources replicated."""
    cap = reg.capacity
    return tree_map(lambda x: _placements(mesh, x.dim() >= 1 and x.shape[0] == cap), world)


def shard_world(app: App, mesh, world: WorldState) -> WorldState:
    """The world as DTensors on ``mesh``: every rank holds the same full
    world (all start from ``init_state()`` and apply the same inputs), so
    each keeps its own block of the capacity axis and wraps it with
    ``DTensor.from_local``; replicated leaves keep their full value (no
    broadcast, which gloo refuses for bool).  A world already sharded
    passes through."""
    from torch.distributed.tensor import DTensor

    if is_dtensor(world.alive):
        return world
    cap = app.reg.capacity
    dev = _local_device(mesh.device_type)
    names = list(mesh.mesh_dim_names)
    n_data = mesh.size(names.index(DATA_AXIS))
    coord = mesh.get_local_rank(DATA_AXIS)
    if cap % n_data:
        raise ValueError(f"capacity {cap} does not divide over {n_data} data ranks")
    block = cap // n_data

    def put(x, placements):
        sharded = any(p.is_shard() for p in placements)
        local = x[coord * block:(coord + 1) * block] if sharded else x
        return DTensor.from_local(local.to(dev).contiguous(), mesh, placements,
                                  run_check=False)

    return tree_map(put, world, world_sharding(app.reg, mesh, world))


def _local(x):
    return x.to_local() if is_dtensor(x) else x


def _as_local_input(x, device: torch.device) -> torch.Tensor:
    """A host array or tensor as a plain tensor on this rank's device."""
    x = _local(x)
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.as_tensor(np.ascontiguousarray(x)).to(device)


def make_sharded_resim_fn(app: App, mesh):
    """resim with the world sharded over the mesh's ``"data"`` axis:
    ``fn(world, inputs_seq, status_seq, start_frame, _unused=None) ->
    (final, stacked, checksums)``, the signature of ``app.resim_fn``.  The
    world is placed with :func:`shard_world` (a sharded one passes
    through); the final world and the stack come back as DTensors with
    the same entity-axis split (the stack's on its axis 1), the checksums
    ``[k, 2]`` as a plain tensor, equal on every rank."""
    from torch.distributed.tensor.experimental import implicit_replication

    from ..ops.resim import resim

    reg, step, fps, seed, retention = app.reg, app.step, app.fps, app.seed, app.retention

    def wrapped(world, inputs_seq, status_seq, start_frame, _unused=None):
        world = shard_world(app, mesh, world)
        dev = _local_device(mesh.device_type)
        with implicit_replication():  # plain constants in the step: replicated
            return resim(reg, step, world, _as_local_input(inputs_seq, dev),
                         _as_local_input(status_seq, dev), int(start_frame),
                         retention, fps, seed)

    return wrapped


def _spec_block(mesh, m: int) -> Tuple[int, int]:
    """This rank's ``[lo, hi)`` block of ``m`` branch lanes over ``"spec"``."""
    n_spec = mesh.size(list(mesh.mesh_dim_names).index(SPEC_AXIS))
    if m % n_spec:
        raise ValueError(f"{m} branches do not divide over {n_spec} spec ranks")
    per = m // n_spec
    j = mesh.get_local_rank(SPEC_AXIS)
    return j * per, (j + 1) * per


def _branch_lanes(app: App, mesh, world, inputs_b, status_b, start_frame, n_real):
    """Run this rank's block of branches, one plain resim per branch on
    the world sharded over the ``"data"`` sub-mesh, and assemble the
    lanes over the full mesh (branches split over ``"spec"``).

    ``torch.func.vmap`` is not run over a DTensor world: each branch goes
    through the plain :func:`~..ops.resim.resim` (or ``resim_padded``
    under a lane count), which the port holds bit-equal to its vmapped
    lanes (``tests/test_torch_speculation.py``)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.experimental import implicit_replication

    from ..ops.resim import resim, resim_padded

    reg, step, fps, seed, retention = app.reg, app.step, app.fps, app.seed, app.retention
    dev = _local_device(mesh.device_type)
    sub = mesh[DATA_AXIS]
    world = shard_world(app, sub, world)
    inputs_b = _as_local_input(inputs_b, dev)
    status_b = _as_local_input(status_b, dev)
    m = inputs_b.shape[0]
    lo, hi = _spec_block(mesh, m)
    finals, stacks, checks = [], [], []
    with implicit_replication():
        for b in range(lo, hi):
            if n_real is None:
                out = resim(reg, step, world, inputs_b[b], status_b[b], int(start_frame),
                            retention, fps, seed)
            else:
                out = resim_padded(reg, step, world, inputs_b[b], status_b[b],
                                   int(start_frame), int(n_real[b]), retention, fps, seed)
            finals.append(out[0])
            stacks.append(out[1])
            checks.append(out[2])
    names = list(mesh.mesh_dim_names)

    def lanes(*xs):
        local = torch.stack([_local(x) for x in xs])
        sharded = is_dtensor(xs[0]) and any(p.is_shard() for p in xs[0].placements)
        axis = xs[0].placements[0].dim + 1 if sharded else None
        pl = [Shard(0) if n == SPEC_AXIS else (Shard(axis) if sharded else Replicate())
              for n in names]
        return DTensor.from_local(local, mesh, pl, run_check=False)

    return (tree_map(lanes, *finals), tree_map(lanes, *stacks), lanes(*checks))


def make_sharded_speculate_fn(app: App, mesh):
    """Speculative fan-out with branches over ``"spec"`` and entities over
    ``"data"``: ``fn(world, inputs_branches [M, k, P, ...], status_branches
    [M, k, P], start_frame, _unused=None) -> (finals[M], stacked[M, k],
    checksums[M, k, 2])``, the signature of ``app.speculate_fn``.  Each
    ``"spec"`` coordinate runs its own block of branches against the world
    sharded over the ``"data"`` sub-mesh; branch lanes never communicate.
    The outputs are DTensors over the full mesh (``full_tensor()`` gathers
    them)."""

    def wrapped(world, inputs_branches, status_branches, start_frame, _unused=None):
        return _branch_lanes(app, mesh, world, inputs_branches, status_branches,
                             start_frame, None)

    return wrapped


def make_sharded_canonical_fn(app: App, mesh):
    """The canonical ``[branches, depth]`` program sharded over the mesh:
    entities over ``"data"``, branch lanes over ``"spec"``.  The signature
    of ``app.branched_fn``: ``fn(world, inputs[B, K, P, ...], status[B, K,
    P], start_frame, n_real[B])``; lane ``b`` advances its first
    ``n_real[b]`` frames and repeats its carried state after them."""
    k_max, branches = app.canonical_depth, app.canonical_branches

    def wrapped(world, inputs_b, status_b, start_frame, n_real):
        if tuple(np.shape(inputs_b)[:2]) != (branches, k_max):
            raise ValueError(f"the branched program takes [{branches}, {k_max}] "
                             f"lanes x frames, not {list(np.shape(inputs_b)[:2])}")
        n_real = [int(n) for n in (n_real.tolist() if hasattr(n_real, "tolist") else n_real)]
        return _branch_lanes(app, mesh, world, inputs_b, status_b, start_frame, n_real)

    return wrapped
