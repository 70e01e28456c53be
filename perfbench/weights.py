"""Seeded weights drawn on the card, part by part, in the types they are served
or trained in.

``draw(layout, seed)`` takes a tree (nested dicts and lists) of meta tensors,
the shapes and dtypes the program lays its parameters out in, and returns
the same tree of tensors drawn on ``device`` from one ``torch.Generator``
seeded with ``seed``, leaf by leaf in the tree's order: each leaf is one
fp32 draw, cut to two standard deviations, scaled and cast to the leaf's
dtype. A product's weight ``w`` (d_in, d_out) and an embedding table
(V, d) have the standard deviation ``1/sqrt(fan_in)`` (d_in, d); a norm's
``scale`` is ``1 + 0.05 n``; biases are zero. The same seed gives the same
tensors, so the reference is handed tensors equal to the program's, drawn
again where the program has changed its own in place.
"""
from __future__ import annotations

import math

import torch


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))


def _leaf(gen, key: str, meta: torch.Tensor, device) -> torch.Tensor:
    shape, dtype = tuple(meta.shape), meta.dtype
    if key in ("b", "bias"):
        return torch.zeros(shape, dtype=dtype, device=device)
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device).clamp_(-2.0, 2.0)
    if key == "scale":
        return x.mul_(0.05).add_(1.0).to(dtype)
    fan_in = shape[-1] if key == "table" else shape[0]
    return x.mul_(1.0 / math.sqrt(fan_in)).to(dtype)


def draw(layout, seed: int, device, requires_grad: bool = False):
    """The tree ``layout`` (meta tensors) drawn on ``device`` from ``seed``."""
    gen = generator(seed, device)

    def walk(node, key):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v, key) for v in node]
        t = _leaf(gen, key, node, device)
        return t.requires_grad_(True) if requires_grad else t

    return walk(layout, "")


def leaves_with_paths(tree, path=()):
    """``[(path, tensor)]`` of ``tree`` in its order."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in leaves_with_paths(v, path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in leaves_with_paths(v, path + (i,))]
    return [(path, tree)]
