"""Nested containers of tensors ("trees"): dicts, lists, tuples and
NamedTuples, with tensors (or other values) at the leaves.

The optimizers map over parameter trees and the checkpoint manager stores
their leaves.  Leaf order and leaf path strings follow JAX's tree
utilities — dict keys sorted, ``['key']`` for a dict entry, ``[i]`` for a
sequence item, ``.field`` for a NamedTuple field, ``None`` an empty
subtree — so sums over leaves run in the reference package's order and a
checkpoint's paths read the same in both packages.
"""
from __future__ import annotations

from typing import Any, Callable

__all__ = ["leaves_with_paths", "leaves", "tree_map"]


def _is_namedtuple(x: Any) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(tree: Any) -> list[tuple[str, Any]] | None:
    """``(path part, child)`` pairs of a container, None for a leaf."""
    if isinstance(tree, dict):
        return [(f"[{k!r}]", tree[k]) for k in sorted(tree)]
    if _is_namedtuple(tree):
        return [(f".{f}", getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, (list, tuple)):
        return [(f"[{i}]", v) for i, v in enumerate(tree)]
    return None


def leaves_with_paths(tree: Any, prefix: str = "") -> list[tuple[str, Any]]:
    """``(path, leaf)`` for every leaf, in JAX's order and path format."""
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    out = []
    for part, child in kids:
        out += leaves_with_paths(child, f"{prefix}/{part}" if prefix
                                 else part)
    return out


def leaves(tree: Any) -> list[Any]:
    """The leaves of ``tree`` in JAX's order."""
    return [leaf for _, leaf in leaves_with_paths(tree)]


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """``fn`` over corresponding leaves of trees of ``tree``'s structure
    (dicts come back with sorted keys).  The recursion follows ``tree``
    alone, so a leaf of ``tree`` may face a container in ``rest``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, v, *(getattr(r, f) for r in rest))
                            for f, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)
