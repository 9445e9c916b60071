"""Parameter trees: nested dicts, lists and NamedTuples of tensors, walked
in the order ``jax.tree_util`` walks them (dict keys sorted, sequences and
NamedTuple fields in order), with the leaf keys the JAX package's checkpoint
manager gives them (``params/backbone/units/0/attn/wq``, ``opt/m/...``,
``opt/step``), so that the two packages name every leaf alike."""
from __future__ import annotations

from typing import Any, Callable, Dict


def _children(node: Any):
    """(key, child) pairs of an inner node, or None for a leaf."""
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return [(f, getattr(node, f)) for f in node._fields]
    if isinstance(node, (list, tuple)):
        return [(str(i), c) for i, c in enumerate(node)]
    return None


def leaf_paths(tree: Any) -> Dict[str, Any]:
    """{"a/b/0/c": leaf} in flatten order."""
    out: Dict[str, Any] = {}

    def walk(node: Any, prefix: str) -> None:
        kids = _children(node)
        if kids is None:
            out[prefix] = node
            return
        for key, child in kids:
            walk(child, f"{prefix}/{key}" if prefix else key)

    walk(tree, "")
    return out


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of ``rest``
    (trees of the same structure); returns a tree of that structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, getattr(tree, f), *(getattr(r, f) for r in rest))
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, c, *(r[i] for r in rest)) for i, c in enumerate(tree))
    return fn(tree, *rest)


def unflatten_like(like: Any, by_key: Dict[str, Any]) -> Any:
    """A tree of ``like``'s structure whose leaves are ``by_key[leaf key]``."""
    def walk(node: Any, prefix: str) -> Any:
        def key(k: str) -> str:
            return f"{prefix}/{k}" if prefix else k
        if isinstance(node, dict):
            return {k: walk(c, key(str(k))) for k, c in node.items()}
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*(walk(getattr(node, f), key(f)) for f in node._fields))
        if isinstance(node, (list, tuple)):
            return type(node)(walk(c, key(str(i))) for i, c in enumerate(node))
        return by_key[prefix]

    return walk(like, "")
