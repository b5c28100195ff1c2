"""Scaling past one device: the lobby mesh and the entity/branch mesh
(``mesh.py``), and multi-host set-up (``multihost.py``).  Port of
``bevy_ggrs_tpu/parallel``; the package's top level does not import it."""

from . import multihost
from .mesh import (
    DATA_AXIS,
    LOBBY_AXIS,
    SPEC_AXIS,
    lobby_sharding,
    make_lobby_mesh,
    make_mesh,
    shard_lobby_worlds,
    world_sharding,
    shard_world,
    make_sharded_resim_fn,
    make_sharded_speculate_fn,
    make_sharded_canonical_fn,
)

__all__ = [
    "multihost",
    "DATA_AXIS",
    "LOBBY_AXIS",
    "SPEC_AXIS",
    "lobby_sharding",
    "make_lobby_mesh",
    "make_mesh",
    "shard_lobby_worlds",
    "world_sharding",
    "shard_world",
    "make_sharded_resim_fn",
    "make_sharded_speculate_fn",
    "make_sharded_canonical_fn",
]
