"""Nested containers of tensors ("trees"), walked in ``jax.tree_util``'s
order: dict keys sorted, named tuples and sequences in order, ``None`` an
empty subtree.  The training state, its moments and the compression
residuals mirror the parameter tree, so one flat leaf index addresses the
same leaf in each (as ``jax.tree.flatten`` does in the JAX package)."""
from __future__ import annotations

from typing import Any, Callable, Iterator, List


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def tree_leaves(tree) -> List[Any]:
    """Every leaf of ``tree`` in the JAX flatten order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over corresponding leaves of ``tree`` and ``rest`` (trees of
    the same structure); containers are rebuilt with their types."""
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


def tree_unflatten_like(tree, leaves) -> Any:
    """``tree``'s structure holding ``leaves`` (in the JAX flatten order)
    in place of its own."""
    it: Iterator = iter(leaves)

    def rec(node):
        if node is None:
            return None
        if isinstance(node, dict):
            new = {k: rec(node[k]) for k in sorted(node)}
            return {k: new[k] for k in node}
        if _is_namedtuple(node):
            return type(node)(*(rec(v) for v in node))
        if isinstance(node, (list, tuple)):
            return type(node)(rec(v) for v in node)
        return next(it)

    out = rec(tree)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


__all__ = ["tree_leaves", "tree_map", "tree_unflatten_like"]
