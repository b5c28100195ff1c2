"""World, checksums, snapshot ring and strategies (port of
``bevy_ggrs_tpu/snapshot``)."""

from .checksum import (
    branch_checksums,
    checksum_to_int,
    component_part,
    entity_part,
    fmix32,
    fold_inputs,
    mix32,
    resource_part,
    to_u32_lanes,
    world_checksum,
    world_checksums,
)
from .persist import (
    Checkpoint,
    load_checkpoint,
    load_world,
    registry_schema,
    save_world,
    schema_digest,
)
from .ring import MissingSnapshotError, SnapshotRing, rollback_many
from .strategy import (
    CloneStrategy,
    CopyStrategy,
    QuantizeStrategy,
    ReflectStrategy,
    Strategy,
)
from .world import (
    ComponentSpec,
    Registry,
    ResourceSpec,
    WorldState,
    active_count,
    active_mask,
    despawn,
    despawn_confirmed,
    despawn_recursive,
    despawn_where,
    insert_component,
    insert_resource,
    remove_component,
    remove_resource,
    spawn,
    spawn_many,
)

__all__ = [
    "SnapshotRing", "MissingSnapshotError", "rollback_many",
    "Strategy", "CopyStrategy", "CloneStrategy", "ReflectStrategy", "QuantizeStrategy",
    "WorldState", "Registry", "ComponentSpec", "ResourceSpec",
    "active_mask", "active_count", "spawn", "spawn_many", "despawn",
    "despawn_where", "despawn_recursive", "despawn_confirmed", "insert_component",
    "remove_component", "insert_resource", "remove_resource",
    "world_checksum", "world_checksums", "branch_checksums", "checksum_to_int",
    "component_part",
    "resource_part", "entity_part", "mix32", "fmix32", "to_u32_lanes",
    "fold_inputs",
    "save_world", "load_world", "load_checkpoint", "Checkpoint", "registry_schema",
    "schema_digest",
]
