"""Multi-host scale-out: the distributed communication backend.

Port of ``bevy_ggrs_tpu/parallel/multihost.py``.  Two communication
planes exist in this framework:

1. **Peer input exchange**: tiny, latency-sensitive, host-side UDP,
   handled by the session layer (Python or the native C++ core).  It never
   touches the device fabric and scales with the number of players.
2. **Simulation sharding**: when ONE world is too big for one card, its
   entity axis splits over a ``DeviceMesh`` of ``torch.distributed`` ranks
   (one per device, NCCL on the cards, gloo on the CPU), whose collectives
   (the checksum's slot all-reduce, ``spawn``'s cumsum and argmax) ride
   NVLink within a host and the network across hosts.  This module wires
   that up.

The mesh puts the entity (``"data"``) axis on the fastest fabric: the ranks
of one host are contiguous along ``"data"``, so the per-frame collectives
stay within the host, and the branch (``"spec"``) axis, which communicates
only when a branch is selected, spans hosts.  With one process this is
:func:`~.mesh.make_mesh`.

Typical deployment (one process per device, all running the same driver):

    from bevy_ggrs_tpu_torch.parallel import multihost
    multihost.initialize(coordinator_address="host0:29500",
                         num_processes=8, process_id=RANK)
    mesh = multihost.make_multihost_mesh(n_spec=2)
    resim = make_sharded_resim_fn(app, mesh)

Every rank runs the same session-driven request stream (rollback netcode
is already a replicated-state model), so the only cross-rank coordination
beyond the collectives is identical inputs, which the session layer
guarantees.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from .mesh import _check_backend, _device_mesh, _device_type, ensure_process_group


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
) -> None:
    """``init_process_group`` at ``tcp://coordinator_address`` (a no-op for
    one process or a process that has a group already).  ``backend``
    defaults to NCCL when a card is present and gloo otherwise; a CUDA
    rank takes device ``process_id % device_count``."""
    if num_processes is None or num_processes <= 1 or dist.is_initialized():
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(int(process_id) % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=int(num_processes), rank=int(process_id))


def make_multihost_mesh(n_spec: int = 1, devices=None):
    """Global ``(data x spec)`` mesh over every rank of every process.

    Ranks are process-major; ``"spec"`` takes the outer (cross-host)
    dimension, so the ``"data"`` axis, which carries the per-frame
    collectives, stays within a host: rank ``j * (n / n_spec) + i`` sits
    at ``(i, j)``, the JAX package's ``reshape(n_spec, n // n_spec).T``.
    ``devices`` names the device type, as in :func:`~.mesh.make_mesh`."""
    device_type = _device_type(devices)
    ensure_process_group(device_type)
    _check_backend(device_type)
    n = dist.get_world_size()
    if n % n_spec:
        raise ValueError(f"{n} ranks not divisible by n_spec={n_spec}")
    grid = np.arange(n).reshape(n_spec, n // n_spec).T  # [data, spec]
    return _device_mesh(device_type, grid)


def process_count() -> int:
    """The group's rank count (1 without a group)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def is_primary() -> bool:
    """True on rank 0 (the coordinating process)."""
    return not dist.is_initialized() or dist.get_rank() == 0
