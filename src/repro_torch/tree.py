"""Nested dicts and lists of tensors (the port's param, gradient and
optimiser-state trees), walked in the JAX package's leaf order: a
dict's keys sorted, a list's items in turn."""
from __future__ import annotations

from typing import Any, Callable


def leaves(tree: Any) -> list[Any]:
    """The leaves of ``tree`` in the reference's ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure), in a tree of that structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def unflatten_like(tree: Any, flat: list[Any]) -> Any:
    """A tree of ``tree``'s structure whose leaves are ``flat``, taken in
    :func:`leaves` order."""
    it = iter(flat)

    def take(node):
        if isinstance(node, dict):
            picked = {k: take(node[k]) for k in sorted(node)}
            return {k: picked[k] for k in node}
        if isinstance(node, (list, tuple)):
            return type(node)(take(v) for v in node)
        return next(it)

    out = take(tree)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out
