"""Disk persistence for world state: save and resume beyond the ring.

Port of ``bevy_ggrs_tpu/snapshot/persist.py``, in the same file format, so
a checkpoint written by either package loads in the other bit for bit.  A
checkpoint is a compressed ``.npz`` of the world's leaves plus its frame:

- the leaves are ``leaf_<i>`` in ``jax.tree.leaves`` order: the world's
  fields in declaration order, each dict by sorted key (the port's own
  ``utils/tree.tree_flatten`` follows registration order, so the order
  here is by name);
- v2 adds the registry *schema*, one ``path:dtype:shape`` row per leaf
  (``.comps['pos']:float32:(64, 3)``, ``.res['rng_counter']:uint32:()``,
  ``.overflow:bool:()``, the JAX package's key paths), its sha256 digest,
  and named ``extra_<name>`` arrays;
- a bfloat16 leaf is written as numpy writes the JAX package's: raw
  16-bit words under the void dtype ``|V2`` (numpy has no bfloat16; this
  module reads and writes the words, no ``ml_dtypes``).

A load against a drifted registry names the mismatched leaves, and a
dtype mismatch raises unless ``allow_cast=True`` (a cast changes bits, so
a resumed run would leave its control run's trajectory).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..utils.device import DeviceLike, resolve_device
from .world import Registry, WorldState

_FORMAT_VERSION = 2
_V1 = 1
_BF16_WORDS = np.dtype("V2")


@dataclasses.dataclass(frozen=True)
class Checkpoint:
    """A loaded checkpoint: the world, its frame, and any extra payloads."""

    world: WorldState
    frame: int
    extras: Dict[str, np.ndarray]


def _paths(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """``(key path, leaf)`` of every leaf in ``jax.tree.leaves`` order, the
    paths spelt as ``jax.tree_util.keystr`` spells them."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _paths(tree[k], f"{prefix}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [x for i, t in enumerate(tree) for x in _paths(t, f"{prefix}[{i}]")]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [x for f in dataclasses.fields(tree)
                for x in _paths(getattr(tree, f.name), f"{prefix}.{f.name}")]
    return [(prefix, tree)]


def _rebuild(tree: Any, leaves: Dict[str, Any], prefix: str = "") -> Any:
    """``tree``'s structure with each leaf taken from ``leaves`` by path."""
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaves, f"{prefix}[{k!r}]") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(t, leaves, f"{prefix}[{i}]") for i, t in enumerate(tree))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _rebuild(getattr(tree, f.name), leaves, f"{prefix}.{f.name}")
            for f in dataclasses.fields(tree)})
    return leaves[prefix]


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def _leaf_rows(template: WorldState) -> List[str]:
    return [f"{path}:{_dtype_name(t)}:{tuple(t.shape)}" for path, t in _paths(template)]


def registry_schema(reg: Registry) -> List[str]:
    """The registry's checkpoint schema: one ``path:dtype:shape`` row per
    world leaf, in flatten order (the JAX package's rows, row for row)."""
    return _leaf_rows(reg.init_state("cpu"))


def _digest(rows: List[str]) -> str:
    return hashlib.sha256("\n".join(rows).encode()).hexdigest()


def schema_digest(reg: Registry) -> str:
    """sha256 hex digest of :func:`registry_schema`: the "same registry?"
    value recorded in every v2 checkpoint, equal in both packages."""
    return _digest(registry_schema(reg))


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(_BF16_WORDS)
    return t.numpy()


def save_world(path, reg: Registry, world: WorldState, frame: int = 0,
               extras: Optional[Dict[str, np.ndarray]] = None) -> None:
    """Write a world (and its frame) as a compressed ``.npz`` checkpoint.

    ``extras`` attaches named side arrays (``extra_<name>``).  ``path`` may
    be a filename or a file-like object (``np.savez_compressed``'s
    contract)."""
    schema = registry_schema(reg)
    leaves = [t for _, t in _paths(world)]
    payload = {f"leaf_{i}": _to_numpy(x) for i, x in enumerate(leaves)}
    for name, arr in (extras or {}).items():
        if not name or not name.isidentifier():
            raise ValueError(f"extra name {name!r} must be an identifier")
        payload[f"extra_{name}"] = np.asarray(arr)
    np.savez_compressed(
        path,
        __version__=_FORMAT_VERSION,
        __frame__=frame,
        __n_leaves__=len(leaves),
        __schema__=np.array(json.dumps(schema)),
        __schema_digest__=np.array(_digest(schema)),
        **payload,
    )


def _schema_mismatch_error(saved: List[str], want: List[str]) -> ValueError:
    """Name the drifted leaves, not just their count."""
    saved_set, want_set = set(saved), set(want)
    only_ckpt = sorted(saved_set - want_set)
    only_reg = sorted(want_set - saved_set)
    parts = ["checkpoint schema does not match the registry"]
    if only_ckpt:
        parts.append(f"checkpoint-only leaves: {only_ckpt}")
    if only_reg:
        parts.append(f"registry-only leaves: {only_reg}")
    if not only_ckpt and not only_reg:
        parts.append("same leaves, different order — registration order changed")
    parts.append("(registered types changed since the save?)")
    return ValueError("; ".join(parts))


def _dtype_only_drift(saved: List[str], want: List[str]) -> bool:
    """True when the two schemas differ only in leaf dtypes (same paths and
    shapes, same order): the one drift ``allow_cast=True`` may bridge."""
    if len(saved) != len(want):
        return False
    for s, w in zip(saved, want):
        sp, wp = s.split(":"), w.split(":")
        if len(sp) != 3 or len(wp) != 3 or sp[0] != wp[0] or sp[2] != wp[2]:
            return False
    return True


def _leaf_tensor(arr: np.ndarray, t: torch.Tensor, name: str, i: int,
                 allow_cast: bool) -> torch.Tensor:
    """A saved leaf as a CPU tensor of the template leaf ``t``'s dtype."""
    if arr.dtype == _BF16_WORDS:  # raw bfloat16 words
        got = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        got = torch.from_numpy(np.array(arr))
    if got.dtype != t.dtype:
        if not allow_cast:
            raise ValueError(
                f"leaf {name} (#{i}) dtype {_dtype_name(got)} != registry dtype "
                f"{_dtype_name(t)} — loading would silently change bits and "
                "desync a resumed/migrated run; pass allow_cast=True only if you "
                "mean to convert"
            )
        got = got.to(t.dtype)
    return got


def load_checkpoint(path, reg: Registry, allow_cast: bool = False,
                    device: DeviceLike = None) -> Checkpoint:
    """Load a checkpoint written by :func:`save_world` (or by the JAX
    package's), schema-checked, onto ``device`` (``None`` = CUDA).

    A v2 checkpoint's schema must match the registry's: any drift raises a
    ValueError naming the mismatched leaves, a dtype-only drift too unless
    ``allow_cast=True``.  A v1 checkpoint (no schema) is checked by leaf
    count and then leaf by leaf."""
    dev = resolve_device(device)
    z = np.load(path, allow_pickle=False)
    version = int(z["__version__"])
    if version not in (_V1, _FORMAT_VERSION):
        raise ValueError(f"unsupported checkpoint version {version}")
    template = reg.init_state("cpu")
    paths = _paths(template)
    want_schema = _leaf_rows(template)
    n = int(z["__n_leaves__"])
    if version >= _FORMAT_VERSION:
        saved_schema = json.loads(str(z["__schema__"]))
        if str(z["__schema_digest__"]) != _digest(want_schema):
            if not (_dtype_only_drift(saved_schema, want_schema) and allow_cast):
                raise _schema_mismatch_error(saved_schema, want_schema)
    elif n != len(paths):
        raise ValueError(f"checkpoint has {n} leaves; registry expects {len(paths)} "
                         "(registered types changed?)")
    leaves = {}
    for i, (name, t) in enumerate(paths):
        arr = z[f"leaf_{i}"]
        if arr.shape != tuple(t.shape):
            raise ValueError(f"leaf {name} (#{i}) shape {arr.shape} != registry shape "
                             f"{tuple(t.shape)}")
        leaves[name] = _leaf_tensor(arr, t, name, i, allow_cast).to(dev)
    extras = {k[len("extra_"):]: z[k] for k in z.files if k.startswith("extra_")}
    return Checkpoint(world=_rebuild(template, leaves), frame=int(z["__frame__"]),
                      extras=extras)


def load_world(path, reg: Registry, allow_cast: bool = False,
               device: DeviceLike = None) -> Tuple[WorldState, int]:
    """``(world, frame)`` of a checkpoint (:func:`load_checkpoint`)."""
    ck = load_checkpoint(path, reg, allow_cast=allow_cast, device=device)
    return ck.world, ck.frame
