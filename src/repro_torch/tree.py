"""Nested containers of tensors (the port's counterpart of JAX's pytrees).

A tree is a dict, list, tuple or NamedTuple of trees, ``None`` (an empty
subtree: no leaves, kept as it is) or a leaf (anything else: a tensor, a numpy
array, a number). Leaves are visited in one order everywhere: dict entries by
sorted key (as ``jax.tree_util`` orders them), lists, tuples and NamedTuples
by position. The checkpoint manager writes leaves in this order.
"""
from __future__ import annotations

from typing import Any, Iterator, List, Tuple


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def leaves_with_paths(tree, prefix: Tuple = ()) -> List[Tuple[Tuple, Any]]:
    """[(path, leaf)] in leaf order; a path is the tuple of dict keys, field
    names and positions from the root to the leaf."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in leaves_with_paths(tree[k], prefix + (k,))]
    if _is_namedtuple(tree):
        return [kv for k, v in zip(tree._fields, tree)
                for kv in leaves_with_paths(v, prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree) for kv in leaves_with_paths(v, prefix + (i,))]
    return [(prefix, tree)]


def leaves(tree) -> list:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def rebuild(template, new_leaves):
    """``template``'s structure with its leaves replaced, in leaf order, by
    ``new_leaves``; their count must match."""
    it = iter(new_leaves)
    out = _rebuild(template, it)
    if next(it, _END) is not _END:
        raise ValueError("more leaves than the template holds")
    return out


_END = object()


def _rebuild(node, it: Iterator):
    if node is None:
        return None
    if isinstance(node, dict):
        built = {k: _rebuild(node[k], it) for k in sorted(node)}
        return {k: built[k] for k in node}
    if _is_namedtuple(node):
        return type(node)(*(_rebuild(v, it) for v in node))
    if isinstance(node, (list, tuple)):
        return type(node)(_rebuild(v, it) for v in node)
    leaf = next(it, _END)
    if leaf is _END:
        raise ValueError("fewer leaves than the template holds")
    return leaf


def map_leaves(fn, tree):
    """``tree`` with ``fn`` applied to each leaf."""
    return rebuild(tree, [fn(leaf) for leaf in leaves(tree)])
