"""Mesh construction over the default process group.

Defined as functions (never module-level state), so importing this module
touches no process group and no device. Each returns a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the default
group, which the caller has set up (``torch.distributed.run`` gives each
process its ``RANK`` and ``WORLD_SIZE``; ``launch/train.py`` makes a one-rank
group itself). The mesh's device type follows the group's backend: ``cuda``
under NCCL, ``cpu`` under gloo or the fake group that plans a mesh larger
than the host.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


class MeshSizeError(ValueError):
    """The process group does not hold the ranks the mesh asks for."""


def make_mesh(shape, axes) -> DeviceMesh:
    """A mesh of ``shape`` over the named ``axes``; the default group must
    have exactly ``prod(shape)`` ranks."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in length")
    n = math.prod(shape)
    if not dist.is_initialized():
        raise MeshSizeError(f"a {shape} mesh over {axes} needs a process group of {n} "
                            "rank(s); none is initialised")
    world = dist.get_world_size()
    if world != n:
        raise MeshSizeError(f"a {shape} mesh over {axes} needs {n} rank(s); the process "
                            f"group has {world}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.arange(n).reshape(shape), mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """Single pod: 16x16 = 256 ranks (data, model).
    Multi-pod:  2x16x16 = 512 ranks (pod, data, model)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def make_local_mesh(model: int = 1) -> DeviceMesh:
    """Every rank of the default group, folded into (data, model)."""
    if not dist.is_initialized():
        raise MeshSizeError("make_local_mesh needs an initialised process group")
    n = dist.get_world_size()
    return make_mesh((n // model, model), ("data", "model"))
