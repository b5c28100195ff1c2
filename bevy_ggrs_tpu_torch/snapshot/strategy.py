"""Snapshot store/load strategies.

Port of ``bevy_ggrs_tpu/snapshot/strategy.py``.  A strategy is an optional
store/load transform applied when a snapshot is kept and restored.  Copy,
Clone and Reflect coincide (the identity): the port's step functions return
new tensors and never write into a saved one, so a saved tensor is a value.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional


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
