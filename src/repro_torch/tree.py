"""Nested containers of tensors (the port's counterpart of JAX's pytrees).

A tree is a dict, list, tuple or NamedTuple of trees, ``None`` (an empty
subtree: no leaves, kept as it is) or a leaf (anything else: a tensor, a numpy
array, a number). Leaves are visited in one order everywhere: dict entries by
sorted key (as ``jax.tree_util`` orders them), lists, tuples and NamedTuples
by position. The checkpoint manager writes leaves in this order. Where a
tree's leaves are themselves tuples (the sharding rules' specs and placements),
``is_leaf`` names them, as ``jax.tree_util``'s argument of that name does.
"""
from __future__ import annotations

from typing import Any, Iterator, List, Tuple


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def leaves_with_paths(tree, prefix: Tuple = (), is_leaf=None) -> List[Tuple[Tuple, Any]]:
    """[(path, leaf)] in leaf order; a path is the tuple of dict keys, field
    names and positions from the root to the leaf."""
    if tree is None:
        return []
    if is_leaf is not None and is_leaf(tree):
        return [(prefix, tree)]
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in leaves_with_paths(tree[k], prefix + (k,), is_leaf)]
    if _is_namedtuple(tree):
        return [kv for k, v in zip(tree._fields, tree)
                for kv in leaves_with_paths(v, prefix + (k,), is_leaf)]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree)
                for kv in leaves_with_paths(v, prefix + (i,), is_leaf)]
    return [(prefix, tree)]


def leaves(tree, is_leaf=None) -> list:
    return [leaf for _, leaf in leaves_with_paths(tree, is_leaf=is_leaf)]


def rebuild(template, new_leaves, is_leaf=None):
    """``template``'s structure with its leaves replaced, in leaf order, by
    ``new_leaves``; their count must match."""
    it = iter(new_leaves)
    out = _rebuild(template, it, is_leaf)
    if next(it, _END) is not _END:
        raise ValueError("more leaves than the template holds")
    return out


_END = object()


def _rebuild(node, it: Iterator, is_leaf):
    if node is None:
        return None
    if is_leaf is None or not is_leaf(node):
        if isinstance(node, dict):
            built = {k: _rebuild(node[k], it, is_leaf) for k in sorted(node)}
            return {k: built[k] for k in node}
        if _is_namedtuple(node):
            return type(node)(*(_rebuild(v, it, is_leaf) for v in node))
        if isinstance(node, (list, tuple)):
            return type(node)(_rebuild(v, it, is_leaf) for v in node)
    leaf = next(it, _END)
    if leaf is _END:
        raise ValueError("fewer leaves than the template holds")
    return leaf


def map_leaves(fn, tree, is_leaf=None):
    """``tree`` with ``fn`` applied to each leaf."""
    return rebuild(tree, [fn(leaf) for leaf in leaves(tree, is_leaf)], is_leaf)
