"""Activation-sharding context: model code calls ``constrain(x, kind)`` at
block boundaries (the reference's points). Inside an
``activation_sharding(...)`` scope a ``DTensor`` is redistributed to the
placements of its kind's spec on its own mesh; a plain tensor comes back
unchanged, since it already is a rank's own rows (the trainer hands the model
each rank's batch rows as plain tensors, which is what the residual's
``("data", None, None)`` means). Outside a scope, or for a kind the scope does
not name, ``constrain`` returns ``x`` unchanged.

A spec is the reference's ``PartitionSpec`` written as a plain tuple: one
entry a tensor dim, each ``None``, an axis name or a tuple of axis names.

``data_parallel(mesh)`` is the second scope the model reads. Each rank then
computes over its own rows of the batch, and ``data_sum`` adds a statistic
over the mesh's data axes, so that a quantity the reference computes over the
global batch (the loss's token count, the MoE load-balance statistics) is
global here too. Outside it ``data_sum`` is the identity and ``data_size`` 1.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.parallel import sharding as shd

_STATE = threading.local()


@dataclass(frozen=True)
class ActivationSpecs:
    specs: Dict[str, Tuple] = field(default_factory=dict)

    def get(self, kind: str) -> Optional[Tuple]:
        return self.specs.get(kind)


def current() -> Optional[ActivationSpecs]:
    return getattr(_STATE, "specs", None)


@contextmanager
def activation_sharding(**kinds):
    """activation_sharding(residual=("data", "model", None), ...)"""
    prev = current()
    _STATE.specs = ActivationSpecs(dict(kinds))
    try:
        yield
    finally:
        _STATE.specs = prev


def constrain(x, kind: str = "residual"):
    ctx = current()
    if ctx is None:
        return x
    spec = ctx.get(kind)
    if spec is None or not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    return x.redistribute(mesh, shd.placements(spec, mesh))


# ---------------------------------------------------------------------------
# data-parallel statistics
# ---------------------------------------------------------------------------

# process-wide, not thread-local: the autograd engine runs a CUDA backward, and
# the checkpointed forwards it re-runs, on a thread of its own
_DATA_MESH = None


def data_mesh():
    """The mesh of the enclosing ``data_parallel`` scope, or ``None``."""
    return _DATA_MESH


@contextmanager
def data_parallel(mesh):
    """Within the scope each rank computes over its own batch rows, and
    ``data_sum`` adds over ``mesh``'s data axes (``sharding.fsdp_axes``)."""
    global _DATA_MESH
    prev, _DATA_MESH = _DATA_MESH, mesh
    try:
        yield
    finally:
        _DATA_MESH = prev


def data_size() -> int:
    """How many ranks' rows make the global batch: 1 outside a scope."""
    mesh = data_mesh()
    return 1 if mesh is None else shd.fsdp_size(mesh)


def data_index(mesh) -> int:
    """This rank's position among the data ranks of ``mesh`` (its rows' block
    of the global batch)."""
    sizes = shd.axis_sizes(mesh)
    i = 0
    for a in shd.fsdp_axes(mesh):
        i = i * sizes[a] + mesh.get_local_rank(a)
    return i


def data_sum(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """``x`` summed over the data ranks of ``mesh`` (by default the enclosing
    scope's), as a new tensor without gradient; ``x`` itself without a mesh or
    with one data rank. Every rank of the mesh must call it, in the same order."""
    mesh = mesh if mesh is not None else data_mesh()
    if mesh is None:
        return x
    sizes = shd.axis_sizes(mesh)
    axes = [a for a in shd.fsdp_axes(mesh) if sizes[a] > 1]
    if not axes:
        return x
    out = x.detach().clone()
    for a in axes:
        dist.all_reduce(out, group=mesh.get_group(a))
    return out
