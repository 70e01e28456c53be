"""Parameter and train-state hand-over between the JAX package's pytrees and
this port.

The JAX package stacks every block leaf along a leading layer dim (its layers
are scanned); the port keeps a Python list of per-layer dicts. The subtrees
stacked so, and on how many leading dims, are ``transformer.JAX_STACKED_DIMS``:
``blocks``, an encoder-decoder's ``enc_blocks`` / ``dec_blocks`` and a hybrid
model's ``prologue`` on one, its ``groups`` on two (a list of lists here);
every other entry (a hybrid model's ``shared_attn`` among them) crosses as it
is. Both sides store ``dense`` weights as ``(d_in, d_out)``, used as ``x @ w``,
so no leaf is transposed. The converters take and give numpy arrays only.

A train state crosses as the reference's ``TrainState(params,
OptState(m, v, step), ef_error)`` structure: ``train_state_from_jax`` reads
any object of that shape (the JAX package's own, with numpy leaves), and
``train_state_to_jax`` gives the port's ``TrainState`` / ``OptState``
NamedTuples holding numpy leaves in the JAX layout (blocks stacked).
``jax_layout`` gives the same layout as shapes alone, touching no data: the
checkpoint manager reads a step that the JAX package's manager wrote by it
(``ckpt/manager.py``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from repro_torch.tree import leaves, leaves_with_paths, map_leaves, rebuild
from repro_torch.models.api import resolve_device
from repro_torch.models.transformer import JAX_STACKED_DIMS
from repro_torch.train.optimizer import OptState
from repro_torch.train.trainer import TrainState


def _unstack(node, dims: int):
    """A subtree stacked on ``dims`` leading dims as nested lists of subtrees."""
    if dims == 0:
        return node
    n = len(leaves(node)[0])
    return [_unstack(map_leaves(lambda a, i=i: np.asarray(a)[i], node), dims - 1)
            for i in range(n)]


def _stack(node, dims: int, stack=np.stack):
    """Nested lists ``dims`` deep of subtrees as one subtree stacked on ``dims``
    leading dims (the inverse of ``_unstack``); ``stack`` joins a list of
    leaves into one."""
    if dims == 0:
        return node
    items = [_stack(x, dims - 1, stack) for x in node]
    if isinstance(items[0], dict):
        return {k: _stack([x[k] for x in items], 1, stack) for k in items[0]}
    return stack(items)


def _jax_tree(params, stack=np.stack):
    """A params-shaped tree with each subtree of ``JAX_STACKED_DIMS`` stacked."""
    return {k: _stack(v, JAX_STACKED_DIMS.get(k, 0), stack) for k, v in params.items()}


def _per_tree(state, fn, step=lambda s: s):
    """``state``'s ``TrainState`` structure with ``fn`` applied to each of its
    params-shaped trees (params, the moments, ``ef_error`` where present) and
    ``step`` to the step count."""
    o = state.opt_state
    return TrainState(fn(state.params), OptState(fn(o.m), fn(o.v), step(o.step)),
                      None if state.ef_error is None else fn(state.ef_error))


@dataclass(frozen=True)
class JaxLeaf:
    """One leaf of a train state in the JAX layout, as shapes: its ``shape`` and
    ``dtype``, and ``parts``, the positions in ``tree.leaves`` of the port's
    state of the per-layer leaves it stacks, in row-major order over its
    stacked dims (one position for a leaf that is not stacked)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype
    parts: Tuple[int, ...]


def _stack_layout(items: List[JaxLeaf]) -> JaxLeaf:
    return JaxLeaf((len(items),) + items[0].shape, items[0].dtype,
                   sum((x.parts for x in items), ()))


def jax_layout(state) -> List[Tuple[Tuple, JaxLeaf]]:
    """The JAX layout of the port's train state ``state`` (tensors, DTensors or
    meta tensors): ``[(path, JaxLeaf)]`` in ``jax.tree_util`` leaf order, which
    is the order of the arrays that the JAX package's checkpoint manager writes.
    Reads only each leaf's global shape and dtype."""
    own = [JaxLeaf(tuple(t.shape), t.dtype, (i,)) for i, t in enumerate(leaves(state))]
    return leaves_with_paths(_per_tree(rebuild(state, own),
                                       lambda t: _jax_tree(t, _stack_layout)))


def params_from_jax(cfg, tree: Dict[str, Any], *, device="cuda"):
    """Port-side parameters from the JAX package's tree (leaves as numpy arrays),
    on ``device``: the card unless the caller asks for the CPU."""
    device = resolve_device(device)

    def leaf(a):
        return torch.from_numpy(np.array(a, copy=True)).to(device)

    return {k: map_leaves(leaf, _unstack(v, JAX_STACKED_DIMS.get(k, 0)))
            for k, v in tree.items()}


def params_to_jax(cfg, params) -> Dict[str, Any]:
    """The JAX package's tree layout (numpy leaves, layers stacked on leading dims)."""
    def leaf(t):
        return t.detach().to("cpu").numpy().copy()

    return _jax_tree(map_leaves(leaf, params))


def train_state_from_jax(cfg, state, *, device="cuda") -> TrainState:
    """The port's ``TrainState`` on ``device`` from a JAX-layout train state
    (numpy leaves): params with ``requires_grad``, fp32 moments, the step as a
    0-d int32 tensor, ``ef_error`` or ``None``."""
    device = resolve_device(device)
    params = params_from_jax(cfg, state.params, device=device)
    for p in leaves(params):
        p.requires_grad_(True)
    o = state.opt_state
    step = torch.tensor(int(np.asarray(o.step)), dtype=torch.int32, device=device)
    ef = (None if state.ef_error is None
          else params_from_jax(cfg, state.ef_error, device=device))
    return TrainState(params, OptState(params_from_jax(cfg, o.m, device=device),
                                       params_from_jax(cfg, o.v, device=device), step), ef)


def train_state_to_jax(cfg, state) -> TrainState:
    """``state`` in the JAX layout, numpy leaves: ``TrainState(params,
    OptState(m, v, step), ef_error)`` with ``step`` an int32 0-d array."""
    return _per_tree(state, lambda t: params_to_jax(cfg, t),
                     lambda s: np.asarray(s.detach().to("cpu").numpy(), dtype=np.int32))
