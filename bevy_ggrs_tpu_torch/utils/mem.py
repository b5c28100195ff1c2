"""Device-memory accounting helpers (port of ``bevy_ggrs_tpu/utils/mem.py``)."""

from __future__ import annotations

import torch

from .tree import tree_leaves


def tree_device_bytes(tree) -> int:
    """Total bytes of every tensor leaf in a tree (device or host)."""
    return sum(a.numel() * a.element_size() for a in tree_leaves(tree)
               if isinstance(a, torch.Tensor))
