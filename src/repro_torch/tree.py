"""Parameter trees: nested dicts, lists, tuples and NamedTuples of tensors.

The port's counterpart of the ``jax.tree`` calls the reference's training
code makes.  Leaves come in JAX's order (a dict's keys sorted, a
sequence's items in order), so a walk over leaves (the global gradient
norm's sum, a checkpoint's keys) visits them as the reference does, and a
leaf's path joins its keys and indices with "/" as the reference's
checkpoint keys do.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def _children(tree) -> List[Tuple[str, Any]]:
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return list(zip(tree._fields, tree))
    if isinstance(tree, (list, tuple)):
        return [(str(i), x) for i, x in enumerate(tree)]
    return []


def _is_leaf(tree) -> bool:
    return not isinstance(tree, (dict, list, tuple))


def leaves_with_paths(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """[(path, leaf)] in JAX's order; None is an empty subtree."""
    if tree is None:
        return []
    if _is_leaf(tree):
        return [(prefix, tree)]
    out = []
    for key, child in _children(tree):
        out += leaves_with_paths(child, f"{prefix}/{key}" if prefix else key)
    return out


def leaves(tree) -> list:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def unflatten(template, flat):
    """The tree of ``template``'s structure whose leaves, in leaf order,
    are ``flat``."""
    it = iter(flat)
    return tree_map(lambda _: next(it), template)


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest``; the containers keep their type."""
    if tree is None:
        return None
    if _is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):         # keys in leaf order (sorted)
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    items = [tree_map(fn, x, *(r[i] for r in rest))
             for i, x in enumerate(tree)]
    if hasattr(tree, "_fields"):
        return type(tree)(*items)
    return type(tree)(items)
