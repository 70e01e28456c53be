"""Parameter and train-state hand-over between the JAX package's pytrees and
this port.

The JAX package stacks every block leaf along a leading layer dim (its layers
are scanned); the port keeps a Python list of per-layer dicts. The subtrees
stacked so, and on how many leading dims, are ``transformer.JAX_STACKED_DIMS``:
``blocks`` and a hybrid model's ``prologue`` on one, its ``groups`` on two
(a list of lists here); every other entry (a hybrid model's ``shared_attn``
among them) crosses as it is. Both sides store
``dense`` weights as ``(d_in, d_out)``, used as ``x @ w``, so no leaf is
transposed. The functions take and give numpy arrays only.

A train state crosses as the reference's ``TrainState(params,
OptState(m, v, step), ef_error)`` structure: ``train_state_from_jax`` reads
any object of that shape (the JAX package's own, with numpy leaves), and
``train_state_to_jax`` gives the port's ``TrainState`` / ``OptState``
NamedTuples holding numpy leaves in the JAX layout (blocks stacked).
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.tree import leaves, map_leaves
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


def _stack(node, dims: int):
    """Nested lists ``dims`` deep of subtrees as one subtree stacked on ``dims``
    leading dims (the inverse of ``_unstack``)."""
    if dims == 0:
        return node
    items = [_stack(x, dims - 1) for x in node]
    if isinstance(items[0], dict):
        return {k: _stack([x[k] for x in items], 1) for k in items[0]}
    return np.stack(items, axis=0)


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

    return {k: _stack(map_leaves(leaf, v), JAX_STACKED_DIMS.get(k, 0))
            for k, v in params.items()}


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
    o = state.opt_state
    step = np.asarray(o.step.detach().to("cpu").numpy(), dtype=np.int32)
    ef = None if state.ef_error is None else params_to_jax(cfg, state.ef_error)
    return TrainState(params_to_jax(cfg, state.params),
                      OptState(params_to_jax(cfg, o.m), params_to_jax(cfg, o.v), step), ef)
