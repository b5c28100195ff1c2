"""Minimal tensor trees: dicts, lists, tuples and dataclasses of tensors.

Stands in for ``jax.tree`` over the port's world and resource values.
:func:`tree_leaves` visits leaves in the order ``jax.tree.leaves`` uses
(dict keys sorted), so a resource's lanes fold in the same order in both
packages; :func:`tree_flatten` and :func:`tree_unflatten` follow
:func:`tree_map` (dict insertion order) and round-trip a tree."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` leaf-wise over ``tree`` (and same-shaped ``rest``)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, t, *(r[i] for r in rest)) for i, t in enumerate(tree)]
        return type(tree)(out)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: tree_map(fn, getattr(tree, f.name),
                             *(getattr(r, f.name) for r in rest))
            for f in dataclasses.fields(tree)
        })
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> List[Any]:
    """Leaves of ``tree`` in ``jax.tree.leaves`` order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [x for f in dataclasses.fields(tree)
                for x in tree_leaves(getattr(tree, f.name))]
    return [tree]


def tree_flatten(tree: Any) -> List[Any]:
    """Leaves of ``tree`` in :func:`tree_map`'s visiting order (dict
    insertion order, unlike :func:`tree_leaves`), so
    :func:`tree_unflatten` puts each leaf back in its own field."""
    leaves: List[Any] = []
    tree_map(leaves.append, tree)
    return leaves


def tree_unflatten(template: Any, leaves: List[Any]) -> Any:
    """``template``'s structure with :func:`tree_flatten`'s ``leaves``."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), template)
