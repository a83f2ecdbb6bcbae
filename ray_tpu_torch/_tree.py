"""Trees of params: dicts, lists and tuples with tensors (or anything
else) at the leaves, walked in one order by every helper here."""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, Optional


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


def tree_paths(node: Any, prefix: str = "") -> Dict[str, Any]:
    """The leaves of a tree by dotted path ("actor.encoder.Dense_0.bias",
    "decoder.deconvs.0.w"): trees of the same params may hold their dict
    entries in other orders (a flax tree's, torch's), their paths not."""
    if isinstance(node, dict):
        items: Iterable = node.items()
    elif isinstance(node, (list, tuple)):
        items = enumerate(node)
    else:
        return {prefix: node}
    out: Dict[str, Any] = {}
    for key, value in items:
        out.update(tree_paths(value, f"{prefix}.{key}" if prefix
                              else str(key)))
    return out


def tree_unflatten(tree: Any, leaves: Iterable) -> Any:
    """``tree``'s structure with ``leaves`` (in tree_leaves order)."""
    it = iter(leaves)
    return tree_map(lambda _leaf, _key: next(it), tree)
