"""Parameter trees: nested dicts, lists and NamedTuples of tensors, walked
in the order ``jax.tree_util`` walks them (dict keys sorted, sequences and
NamedTuple fields in order), with the leaf keys the JAX package's checkpoint
manager gives them (``params/backbone/units/0/attn/wq``, ``opt/m/...``,
``opt/step``), so that the two packages name every leaf alike. As in
``jax.tree_util``, ``is_leaf`` marks nodes to take whole (a spec, which is
a tuple, in a tree of specs)."""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional


def _children(node: Any, is_leaf: Optional[Callable[[Any], bool]] = None):
    """(key, child) pairs of an inner node, or None for a leaf."""
    if is_leaf is not None and is_leaf(node):
        return None
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return [(f, getattr(node, f)) for f in node._fields]
    if isinstance(node, (list, tuple)):
        return [(str(i), c) for i, c in enumerate(node)]
    return None


def leaf_paths(tree: Any, is_leaf: Optional[Callable[[Any], bool]] = None
               ) -> Dict[str, Any]:
    """{"a/b/0/c": leaf} in flatten order."""
    out: Dict[str, Any] = {}

    def walk(node: Any, prefix: str) -> None:
        kids = _children(node, is_leaf)
        if kids is None:
            out[prefix] = node
            return
        for key, child in kids:
            walk(child, f"{prefix}/{key}" if prefix else key)

    walk(tree, "")
    return out


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any,
             is_leaf: Optional[Callable[[Any], bool]] = None) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of ``rest``
    (trees of the same structure); returns a tree of that structure."""
    def walk(node: Any, *others: Any) -> Any:
        if is_leaf is not None and is_leaf(node):
            return fn(node, *others)
        if isinstance(node, dict):
            return {k: walk(node[k], *(r[k] for r in others)) for k in node}
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*(walk(getattr(node, f), *(getattr(r, f) for r in others))
                                for f in node._fields))
        if isinstance(node, (list, tuple)):
            return type(node)(walk(c, *(r[i] for r in others)) for i, c in enumerate(node))
        return fn(node, *others)
    return walk(tree, *rest)


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
