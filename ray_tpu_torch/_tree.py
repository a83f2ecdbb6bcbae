"""Trees of params: dicts, lists and tuples with tensors (or anything
else) at the leaves, walked in one order by every helper here."""

from __future__ import annotations

from typing import Any, Callable, Iterable, Optional


def tree_map(fn: Callable[[Any, Optional[str]], Any], node: Any,
             key: Optional[str] = None) -> Any:
    """``fn(leaf, key)`` over a tree, ``key`` the name of the dict entry
    that holds the leaf (a list passes its own on)."""
    if isinstance(node, dict):
        return {k: tree_map(fn, v, k) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(tree_map(fn, v, key) for v in node)
    return fn(node, key)


def tree_leaves(node: Any) -> list:
    """The leaves of a tree, in order."""
    if isinstance(node, dict):
        return [t for v in node.values() for t in tree_leaves(v)]
    if isinstance(node, (list, tuple)):
        return [t for v in node for t in tree_leaves(v)]
    return [node]


def tree_unflatten(tree: Any, leaves: Iterable) -> Any:
    """``tree``'s structure with ``leaves`` (in tree_leaves order)."""
    it = iter(leaves)
    return tree_map(lambda _leaf, _key: next(it), tree)
