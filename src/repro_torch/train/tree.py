"""Parameter trees of the port: nested dicts, per-layer lists and
named tuples of tensors.

The JAX package walks its trees with ``jax.tree_util``; these helpers
keep its conventions where they show: dict keys in sorted order (the
leaf order of ``tree_leaves``, which fixes the order of sums over
leaves and the numbering of checkpoint files), and key paths in
``jax.tree_util.keystr`` syntax (``['layers'][0]['attn']['wq']``,
``.step`` for a named tuple's field).  ``None`` is an empty subtree.
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def flatten_with_paths(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """[(keystr path, leaf), ...] in the JAX package's leaf order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in flatten_with_paths(tree[k], f"{prefix}[{k!r}]")]
    if _is_namedtuple(tree):
        return [kv for f in tree._fields
                for kv in flatten_with_paths(getattr(tree, f),
                                             f"{prefix}.{f}")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree)
                for kv in flatten_with_paths(v, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def paths(tree) -> List[str]:
    return [path for path, _ in flatten_with_paths(tree)]


def leaves(tree) -> List[Any]:
    return [leaf for _, leaf in flatten_with_paths(tree)]


def tree_map(fn: Callable, tree, *rest):
    """``fn(leaf, *matching leaves of rest)`` over ``tree``'s structure
    (``rest`` trees have the same structure; ``None`` stays ``None``)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, v, *(r[i] for r in rest))
                            for i, v in enumerate(tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def map_with_paths(fn: Callable, tree, prefix: str = ""):
    """``fn(keystr path, leaf)`` over ``tree``'s structure."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: map_with_paths(fn, v, f"{prefix}[{k!r}]")
                for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(map_with_paths(fn, getattr(tree, f),
                                           f"{prefix}.{f}")
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_paths(fn, v, f"{prefix}[{i}]")
                          for i, v in enumerate(tree))
    return fn(prefix, tree)


def treedef_str(tree) -> str:
    """The tree's structure with ``*`` for each leaf, as
    ``str(jax.tree_util.tree_structure(...))`` prints a tree of dicts,
    lists and named tuples."""
    def walk(t):
        if t is None:
            return "None"
        if isinstance(t, dict):
            return "{" + ", ".join(f"{k!r}: {walk(t[k])}"
                                   for k in sorted(t)) + "}"
        if _is_namedtuple(t):
            return (f"CustomNode(namedtuple[{type(t).__name__}], ["
                    + ", ".join(walk(v) for v in t) + "])")
        if isinstance(t, list):
            return "[" + ", ".join(walk(v) for v in t) + "]"
        if isinstance(t, tuple):
            return "(" + ", ".join(walk(v) for v in t) + ")"
        return "*"
    return f"PyTreeDef({walk(tree)})"
