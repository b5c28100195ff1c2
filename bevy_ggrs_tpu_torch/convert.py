"""Carry a world across between the JAX package and the port.

A world's leaves are its state (this system's "weights"): the JAX
package's ``WorldState`` and the port's have the same fields, leaves,
dtypes and shapes.  Across the boundary a world travels as a mapping from
field name to numpy arrays (``comps``, ``has``, ``res`` and
``res_present`` are dicts of them, a resource value a tree), so neither
package imports the other.  Leaves cross as they are, whatever their
leading axes and dtypes: a stacked ``[M, ...]`` many-worlds world, a
stacked resim output, a uint32 resource (particles' ``rng_counter``), or
the stored form of a lossy strategy (bfloat16 leaves of
``QuantizeStrategy``, carried bit for bit as raw 16-bit words).

The bfloat16 words go both ways but not in one form.  Into the port,
``world_from_numpy`` takes an ``ml_dtypes.bfloat16`` array or its raw
``|V2`` words.  Out of the port, ``to_numpy`` and ``world_to_numpy`` give
the raw ``|V2`` words (numpy has no bfloat16 and the port does not import
``ml_dtypes``), which ``jnp.asarray`` refuses: the JAX side views such a
leaf as ``ml_dtypes.bfloat16`` before it builds its world.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import numpy as np
import torch

from .snapshot.world import Registry, WorldState
from .utils.device import DeviceLike, resolve_device
from .utils.tree import tree_map


_BF16_WORDS = np.dtype("V2")


def _from_numpy(a: Any, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16" or a.dtype == _BF16_WORDS:
        # numpy has no native bfloat16: an extension dtype's array, or its
        # raw 16-bit words as ``np.load`` returns them
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as a host numpy array; bfloat16 as its raw 16-bit words
    (dtype ``|V2``, the form ``np.savez`` writes for the JAX package's
    bfloat16 leaves; view them as ``uint16`` to compare bits, and as
    ``ml_dtypes.bfloat16`` to hand them to JAX)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(_BF16_WORDS)
    return t.numpy()


def world_from_numpy(reg: Registry, leaves: Mapping[str, Any],
                     device: DeviceLike = None) -> WorldState:
    """Build the port's world from ``{field: numpy leaves}`` on ``device``
    (``None`` = CUDA).  Components and resources must match ``reg``."""
    dev = resolve_device(device)
    if set(leaves["comps"]) != set(reg.components) \
            or set(leaves["res"]) != set(reg.resources):
        raise ValueError("world leaves do not match the registry")
    return WorldState(**{
        f.name: tree_map(lambda a: _from_numpy(a, dev), leaves[f.name])
        for f in dataclasses.fields(WorldState)
    })


def world_to_numpy(w: WorldState) -> dict:
    """The port's world as ``{field: numpy leaves}``."""
    return {f.name: tree_map(to_numpy, getattr(w, f.name))
            for f in dataclasses.fields(WorldState)}
