"""Nested dicts of tensors (parameters, gradients, optimizer moments) as
the reference's pytrees: leaves in ``jax.tree.flatten``'s order (dict keys
sorted), named by their '/'-joined path."""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def flatten(tree, prefix: str = "", *, dicts_only: bool = False
            ) -> List[Tuple[str, Any]]:
    """[(path, leaf)] in the reference's leaf order: dict keys sorted,
    lists and tuples in order (``dicts_only``: lists and tuples are leaves,
    as the specs of a spec tree are)."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += flatten(tree[k], f"{prefix}/{k}" if prefix else str(k),
                           dicts_only=dicts_only)
        return out
    if isinstance(tree, (list, tuple)) and not dicts_only:
        out = []
        for i, v in enumerate(tree):
            out += flatten(v, f"{prefix}/{i}" if prefix else str(i))
        return out
    return [(prefix, tree)]


def leaves(tree, *, dicts_only: bool = False) -> List[Any]:
    return [leaf for _, leaf in flatten(tree, dicts_only=dicts_only)]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` applied leaf by leaf over ``tree`` and trees of its
    structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def unflatten(like, leaves_in_order):
    """A tree of ``like``'s structure holding ``leaves_in_order`` (in the
    order of ``flatten``)."""
    it = iter(leaves_in_order)

    def rec(node):
        if isinstance(node, dict):
            built = {k: rec(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}
        if isinstance(node, (list, tuple)):
            return type(node)(rec(v) for v in node)
        return next(it)

    return rec(like)
