"""Device-memory accounting helpers (port of ``bevy_ggrs_tpu/utils/mem.py``)."""

from __future__ import annotations

import torch

from .tree import tree_leaves


def tree_device_bytes(tree) -> int:
    """Total bytes of every tensor leaf in a tree (device or host)."""
    return sum(a.numel() * a.element_size() for a in tree_leaves(tree)
               if isinstance(a, torch.Tensor))


def tree_storage_bytes(tree) -> int:
    """Bytes of the distinct storages under a tree's tensor leaves: what the
    tree keeps allocated, counting a storage once however many views of it
    the tree holds (a branch slice pins its whole stack)."""
    storages = {}
    for a in tree_leaves(tree):
        if isinstance(a, torch.Tensor):
            st = a.untyped_storage()
            storages[(a.device, st.data_ptr())] = st.nbytes()
    return sum(storages.values())
