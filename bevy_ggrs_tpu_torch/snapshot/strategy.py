"""Snapshot store/load strategies.

Port of ``bevy_ggrs_tpu/snapshot/strategy.py``.  A strategy is an optional
store/load transform applied when a snapshot is kept and restored.  Copy,
Clone and Reflect coincide (the identity): the port's step functions return
new tensors and never write into a saved one, so a saved tensor is a value.
:func:`QuantizeStrategy` stores a column in a narrower dtype (bf16 by
default) to halve the ring's device memory.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch


@dataclass(frozen=True)
class Strategy:
    """Optional store/load transforms applied at snapshot push/restore.

    ``None`` means identity (no work at save/load time)."""

    store: Optional[Callable] = None
    load: Optional[Callable] = None


#: Identity — bitwise snapshot.
CopyStrategy = Strategy()

#: Alias: value semantics make copy and clone identical here.
CloneStrategy = Strategy()

#: Alias: tensor trees are the reflection layer.
ReflectStrategy = Strategy()


def QuantizeStrategy(stored_dtype: torch.dtype = torch.bfloat16) -> Strategy:
    """Store snapshots in a narrower dtype to cut the ring's device memory.

    Lossy against an identity-strategy run, but deterministic and
    checksum-safe: the advance round-trips the live state through
    store -> load every frame (``ops/resim.advance``), so the stored form
    is canonical and a resim from a restored snapshot is bit-identical to
    the live pass.  ``Tensor.to`` rounds to nearest even, as the JAX
    package's ``astype`` does, so the stored bits are the same in both."""
    return Strategy(
        store=lambda a: a.to(stored_dtype),
        load=lambda a: a,  # Registry.load_state casts back to the live dtype
    )
