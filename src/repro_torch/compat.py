"""Parameter hand-over between the JAX package's pytrees and this port.

The JAX package stacks every block leaf along a leading layer dim (its layers
are scanned); the port keeps a Python list of per-layer dicts. Both sides store
``dense`` weights as ``(d_in, d_out)``, used as ``x @ w``, so no leaf is
transposed. The functions take and give numpy arrays only.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.models.api import resolve_device


def _map(node, fn):
    if isinstance(node, dict):
        return {k: _map(v, fn) for k, v in node.items()}
    return fn(node)


def params_from_jax(cfg, tree: Dict[str, Any], *, device="cuda"):
    """Port-side parameters from the JAX package's tree (leaves as numpy arrays),
    on ``device``: the card unless the caller asks for the CPU."""
    n = cfg.num_layers
    device = resolve_device(device)

    def leaf(a):
        return torch.from_numpy(np.array(a, copy=True)).to(device)

    out = {k: _map(v, leaf) for k, v in tree.items() if k != "blocks"}
    out["blocks"] = [_map(tree["blocks"], lambda a, i=i: leaf(np.asarray(a)[i]))
                     for i in range(n)]
    return out


def params_to_jax(cfg, params) -> Dict[str, Any]:
    """The JAX package's tree layout (numpy leaves, blocks stacked on a leading dim)."""
    def leaf(t):
        return t.detach().to("cpu").numpy().copy()

    out = {k: _map(v, leaf) for k, v in params.items() if k != "blocks"}
    blocks = [_map(b, leaf) for b in params["blocks"]]

    def stack(nodes):
        if isinstance(nodes[0], dict):
            return {k: stack([nd[k] for nd in nodes]) for k in nodes[0]}
        return np.stack(nodes, axis=0)

    out["blocks"] = stack(blocks)
    return out
