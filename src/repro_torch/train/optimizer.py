"""Optimizer substrate: AdamW + global-norm clipping + LR schedules (cosine and
MiniCPM's WSD), written on tensors.

The formulas are the reference's (``src/repro/train/optimizer.py``), not
``torch.optim.AdamW`` with ``clip_grad_norm_``: the clip here scales by
``min(1, clip / max(norm, 1e-9))`` where torch's uses ``clip / (norm + 1e-6)``,
and the decay mask goes by the leaf's key path (no decay on ``b``, ``scale``
or ``bias``, nor on any leaf of fewer than 2 dims as the reference stores it:
its layers are stacked, so a layer's 1-d leaf has 2 dims there and is decayed,
``reference_ndim``). ``apply_updates`` updates
the parameters and the moments in place (``torch._foreach_*``), where the
reference returns new trees; the step count stays a 0-d int32 tensor on the
parameters' device, so no step reads a number back from the card.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch import tree
from repro_torch.models.transformer import JAX_STACKED_DIMS


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 1000
    schedule: str = "cosine"          # cosine | wsd | const
    wsd_stable_frac: float = 0.8      # WSD: fraction of steps at peak LR
    min_lr_frac: float = 0.1


class OptState(NamedTuple):
    m: dict
    v: dict
    step: torch.Tensor                # 0-d int32


def schedule_lr(cfg: OptConfig, step):
    """Learning rate at ``step`` (an int or a tensor) as an fp32 0-d tensor,
    on the step's device."""
    step = (step.float() if isinstance(step, torch.Tensor)
            else torch.tensor(float(step), dtype=torch.float32))
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    if cfg.schedule == "const":
        return cfg.lr * warm
    if cfg.schedule == "cosine":
        t = torch.clamp((step - cfg.warmup_steps)
                        / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
        cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (1 + torch.cos(math.pi * t))
        return cfg.lr * warm * cos
    if cfg.schedule == "wsd":
        # Warmup-Stable-Decay (MiniCPM): flat at peak, then 1-sqrt decay
        stable_end = cfg.warmup_steps + cfg.wsd_stable_frac * (
            cfg.total_steps - cfg.warmup_steps)
        t = torch.clamp((step - stable_end) / max(cfg.total_steps - stable_end, 1),
                        0.0, 1.0)
        decay = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * (1.0 - torch.sqrt(t))
        return cfg.lr * warm * torch.where(step < stable_end, torch.ones_like(decay), decay)
    raise ValueError(cfg.schedule)


def init(params) -> OptState:
    zeros = tree.map_leaves(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                  device=p.device), params)
    device = tree.leaves(params)[0].device
    return OptState(m=zeros, v=tree.map_leaves(torch.clone, zeros),
                    step=torch.zeros((), dtype=torch.int32, device=device))


def global_norm(grads):
    """sqrt of the sum of squares of every leaf, summed in fp64 and returned in
    fp32: torch's fp32 norm on the CPU drifts by ~1e-4 on a leaf of millions of
    elements (a whisper model's ``pos_dec``), where the reference's fp32 sum
    does not.

    ``DTensor`` leaves (one mesh) give their full tensors' norm: each rank sums
    its shards' squares, each divided by the number of ranks that hold a copy
    of it, and one all-reduce a mesh dim adds the ranks' sums (DTensor's own
    norm would reduce each leaf on its own)."""
    gs = tree.leaves(grads)
    norms = torch._foreach_norm([_local(g) for g in gs], 2, dtype=torch.float64)
    sq = torch.stack([n * n / _copies(g) for n, g in zip(norms, gs)]).sum()
    if isinstance(gs[0], DTensor):
        mesh = gs[0].device_mesh
        for i in range(mesh.ndim):
            if mesh.size(i) > 1:
                dist.all_reduce(sq, group=mesh.get_group(i))
    return torch.sqrt(sq).float()


def _copies(t) -> int:
    """How many ranks hold each element of a ``DTensor`` (1 for a plain tensor)."""
    if not isinstance(t, DTensor):
        return 1
    return math.prod(t.device_mesh.size(i) for i, p in enumerate(t.placements)
                     if p.is_replicate())


def _local(t):
    """A ``DTensor``'s shard on this rank (a view: updates land in the
    ``DTensor``), a plain tensor itself."""
    return t.to_local() if isinstance(t, DTensor) else t


def _decay_mask(path) -> bool:
    """No weight decay on norms/bias (the caller also spares 1-d params)."""
    return str(path[-1]) not in ("b", "scale", "bias")


def reference_ndim(path, p) -> int:
    """The rank the reference's decay rule sees: ``p``'s own, plus the layer
    dims the JAX package stacks the leaf's subtree on. So a Mamba2 layer's
    ``A_log``, ``D``, ``dt_bias`` and ``conv_b`` are decayed there and here,
    the shared attention block's 1-d leaves (not stacked) are not."""
    return p.dim() + JAX_STACKED_DIMS.get(path[0], 0)


@torch.no_grad()
def apply_updates(cfg: OptConfig, params, grads, state: OptState):
    """AdamW step. ``grads`` has the structure of ``params``; its fp32 tensors
    are used as scratch and overwritten. Updates ``params``, ``state.m`` and
    ``state.v`` in place and returns (params, new_state, metrics).

    The leaves may be ``DTensor``s, a parameter's gradient and moments placed
    as it is (the sharded step): the norm is then the full gradients' and each
    rank updates its shards, the update being elementwise."""
    named = tree.leaves_with_paths(params)
    gs = [g.float() for g in tree.leaves(grads)]
    gnorm = global_norm(gs)
    ps = [_local(p) for _, p in named]
    gs = [_local(g) for g in gs]
    ms = [_local(m) for m in tree.leaves(state.m)]
    vs = [_local(v) for v in tree.leaves(state.v)]
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    step = state.step + 1
    lr = schedule_lr(cfg, step)
    b1, b2 = cfg.beta1, cfg.beta2
    bc1 = 1 - b1 ** step.float()
    bc2 = 1 - b2 ** step.float()

    # the gradients are scaled in place, then overwritten by the denominator:
    # one gradient-sized temporary (delta) besides them
    torch._foreach_mul_(gs, scale)
    torch._foreach_mul_(ms, b1)
    torch._foreach_add_(ms, gs, alpha=1 - b1)
    torch._foreach_mul_(vs, b2)
    torch._foreach_addcmul_(vs, gs, gs, value=1 - b2)
    den = gs
    torch._foreach_copy_(den, vs)
    torch._foreach_div_(den, bc2)
    torch._foreach_sqrt_(den)
    torch._foreach_add_(den, cfg.eps)
    delta = torch._foreach_div(ms, bc1)
    torch._foreach_div_(delta, den)
    decay = [i for i, (path, p) in enumerate(named)
             if _decay_mask(path) and reference_ndim(path, p) >= 2]
    if decay and cfg.weight_decay:
        torch._foreach_add_([delta[i] for i in decay], [ps[i].float() for i in decay],
                            alpha=cfg.weight_decay)
    torch._foreach_mul_(delta, lr)
    torch._foreach_sub_(ps, [d.to(p.dtype) for d, p in zip(delta, ps)])
    return params, OptState(state.m, state.v, step), {"grad_norm": gnorm, "lr": lr}
