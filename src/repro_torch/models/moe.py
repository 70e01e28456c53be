"""Mixture-of-Experts block: top-k routing with capacity-bounded dispatch.

Two interchangeable implementations (the same numbers where no tokens drop):

* ``einsum`` — GShard-style one-hot dispatch/combine einsums over token
  groups. Default.
* ``scatter`` — cumsum positions and ``index_add`` into capacity buffers
  (no one-hot dispatch FLOPs).

Expert weights are stored ``(E, d, ff)`` / ``(E, ff, d)``; the expert products
are batched matmuls over the expert dim. Routing is computed in fp32 from an
fp32 router (``transformer.cast_params`` leaves it fp32). A token whose choice
finds its expert's queue full is dropped for that choice (its slot is the extra
column ``cap``, cut off before the experts run), as in the reference.

Inside ``parallel.ctx.model_parallel`` the layout (``parallel.ctx.layout()``)
says how the experts are split over ``model``: EP (``"ep"``), each rank
holding ``E/tp`` whole experts; TP within the experts (``"tp"``), each rank
holding every expert's share of ``d_ff`` for ``wg`` / ``wu`` and ``wd`` as
``layers.dense_joined`` takes it; or not at all. The experts' outputs are
joined over ``model``, so that the router, the load-balance loss and the
combine run alike on every model rank, as on one device. The dispatched
tokens' gradient is the ranks' fp32 partials summed and rounded once: under
EP by ``_Dispatch`` (or, in the scatter dispatch, ``to_model`` on an fp32
copy), under TP within the experts by ``layers.split_input``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models import layers
from repro_torch.parallel import ctx as pctx


def moe_init(gen: torch.Generator, cfg):
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    return {
        "router": layers.truncated_normal(gen, (d, E), 0.02),
        "wg": layers.truncated_normal(gen, (E, d, ff), 1.0 / math.sqrt(d)),
        "wu": layers.truncated_normal(gen, (E, d, ff), 1.0 / math.sqrt(d)),
        "wd": layers.truncated_normal(gen, (E, ff, d), 1.0 / math.sqrt(ff)),
    }


def _route(p, x2d, cfg):
    """x2d: (T, d) -> (weights (T,k), experts (T,k), probs (T,E))."""
    logits = x2d.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    w, idx = torch.topk(probs, cfg.experts_per_token, dim=-1)
    w = w / torch.clamp(w.sum(dim=-1, keepdim=True), min=1e-9)
    return w.float(), idx, probs


def aux_load_balance_loss(probs, idx, num_experts):
    """Switch-style load-balance loss (mean fraction * mean prob * E).

    Inside ``parallel.ctx.data_parallel`` the reference's global batch is the
    data ranks' rows together: the expert counts are summed over the ranks,
    and this rank's term holds its own probabilities' share of the global
    mean, so the ranks' terms add up to the global loss."""
    flat = idx.reshape(-1)
    # bincount's numbers with a static shape (bincount's size depends on the data)
    counts = torch.zeros(num_experts, dtype=torch.int64, device=idx.device).scatter_add_(
        0, flat, torch.ones_like(flat)).float()
    n_ranks = pctx.data_size()
    if n_ranks == 1:
        return num_experts * torch.sum(counts / max(idx.numel(), 1) * probs.mean(dim=0))
    frac = pctx.data_sum(counts) / (idx.numel() * n_ranks)
    return num_experts * torch.sum(frac * probs.sum(dim=0) / (probs.shape[0] * n_ranks))


def _expert_mode() -> str:
    """How the layout splits the experts over ``model``: "ep", "tp" or "none"
    (also outside ``parallel.ctx.model_parallel``)."""
    lay = pctx.layout()
    return "none" if lay is None else lay.experts


def _expert_ffn(p, xin, cfg, dt):
    """xin: (..., E, C, d) -> (..., E, C, d) through each expert's gated MLP.
    Under EP ``p`` holds this rank's experts and ``xin`` their slots, and the
    ranks' outputs are joined; under TP within the experts the products are
    ``layers.split_mm`` and ``layers.joined_mm``."""
    act = F.silu if cfg.mlp == "swiglu" else layers._gelu
    mode = _expert_mode()
    if mode == "tp":
        xs = layers.split_input(xin)
        h = act(layers.split_mm(xs, p["wg"].to(dt))) * layers.split_mm(xs, p["wu"].to(dt))
        return layers.joined_mm(h, p["wd"].to(dt), join=pctx.layout().d_model)
    g = torch.einsum("...ecd,edf->...ecf", xin, p["wg"].to(dt))
    u = torch.einsum("...ecd,edf->...ecf", xin, p["wu"].to(dt))
    y = torch.einsum("...ecf,efd->...ecd", act(g) * u, p["wd"].to(dt))
    return pctx.gather_from_model(y, -3) if mode == "ep" else y


class _Dispatch(torch.autograd.Function):
    """The dispatch einsum of this model rank's experts' slots: the tokens'
    gradient is the ranks' partials taken in fp32, summed and rounded once."""

    @staticmethod
    def forward(ctx, disp, xg, group):
        ctx.save_for_backward(disp)
        ctx.group, ctx.x_dtype = group, xg.dtype
        return torch.einsum("ngec,ngd->necd", disp, xg)

    @staticmethod
    def backward(ctx, dxin):
        disp, = ctx.saved_tensors
        part = torch.einsum("ngec,necd->ngd", disp.float(), dxin.float())
        return None, pctx.all_reduce_f32(part, ctx.group).to(ctx.x_dtype), None


def _experts(cfg):
    """The experts whose tokens this model rank computes: its own under EP,
    all of them otherwise."""
    if _expert_mode() != "ep":
        return slice(0, cfg.num_experts)
    n = cfg.num_experts // pctx.model_size()
    return slice(pctx.model_index() * n, (pctx.model_index() + 1) * n)


def moe_apply_einsum(p, x, cfg, *, group_size: int = 512):
    """x: (B, S, d) -> (y, aux_loss). One-hot grouped dispatch.

    The B * S tokens are cut into groups of ``min(group_size, B * S)``; a token
    count that is not a whole number of groups raises ``ValueError``. Inside
    ``parallel.ctx.data_parallel`` the reference groups the global batch's
    tokens: a rank whose rows hold fewer than ``group_size`` tokens would form
    other groups (a group of the reference's spans ranks), and raises
    ``ValueError`` (ROADMAP C27).
    """
    B, S, d = x.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    dt = layers.to_dtype(cfg.compute_dtype)
    T = B * S
    g = min(group_size, T)
    if T % g:
        raise ValueError(f"moe einsum dispatch: {T} tokens (B={B} x S={S}) do not "
                         f"split into groups of {g}")
    if T < group_size and pctx.data_size() > 1:
        raise ValueError(f"moe einsum dispatch: a data rank's {T} tokens are fewer than "
                         f"a group of {group_size}; the global batch's groups would span "
                         "ranks")
    n_grp = T // g
    x2 = x.reshape(T, d)
    w, idx, probs = _route(p, x2, cfg)
    aux = aux_load_balance_loss(probs, idx, E)

    cap = max(1, int(g * k / E * cfg.capacity_factor))
    xg = x2.reshape(n_grp, g, d)
    wg_ = w.reshape(n_grp, g, k)
    ig = idx.reshape(n_grp, g, k)

    # position of each (token, choice) within its expert queue, per group
    onehot = F.one_hot(ig, E)                                   # (n,g,k,E)
    pos = (torch.cumsum(onehot.reshape(n_grp, g * k, E), dim=1) - 1
           ).reshape(n_grp, g, k, E)
    in_cap = (pos < cap) & (onehot > 0)

    # dispatch tensor (n, g, E, cap): 1 where token t goes to slot (e, c);
    # unselected and overflowing (token, choice, expert) triples go to the
    # dropped column cap, cut off here
    slot = F.one_hot(torch.where(in_cap, pos, cap), cap + 1).to(dt)[..., :cap]
    disp = slot.sum(dim=2)                                      # (n,g,E,cap)
    comb = (slot * wg_[..., None, None].to(dt)).sum(dim=2)

    if _expert_mode() == "ep":                       # this rank's experts
        xin = _Dispatch.apply(disp[:, :, _experts(cfg)], xg.to(dt), pctx.model_group())
    else:
        xin = torch.einsum("ngec,ngd->necd", disp, xg.to(dt))
    xin = pctx.constrain(xin, "moe_tokens")                     # (n,E,cap,d)
    yout = pctx.constrain(_expert_ffn(p, xin, cfg, dt), "moe_tokens")
    y = torch.einsum("ngec,necd->ngd", comb, yout)
    return y.reshape(B, S, d).to(x.dtype), aux


def moe_apply_scatter(p, x, cfg):
    """Dispatch without one-hot FLOPs: ``index_add`` into capacity buffers.

    All B * S tokens are one group, so inside ``parallel.ctx.data_parallel``
    (where the reference's group is the global batch's tokens) it raises
    ``ValueError`` over more than one data rank (ROADMAP C27)."""
    if pctx.data_size() > 1:
        raise ValueError("moe scatter dispatch: one group of the global batch's tokens "
                         "spans the data ranks; use the einsum dispatch")
    B, S, d = x.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    dt = layers.to_dtype(cfg.compute_dtype)
    T = B * S
    x2 = x.reshape(T, d)
    w, idx, probs = _route(p, x2, cfg)
    aux = aux_load_balance_loss(probs, idx, E)

    cap = max(1, int(T * k / E * cfg.capacity_factor))
    flat_e = idx.reshape(-1)                                    # (T*k,)
    rows = torch.arange(T * k, device=x.device)
    pos = (torch.cumsum(F.one_hot(flat_e, E), dim=0) - 1)[rows, flat_e]
    keep = pos < cap
    safe_pos = torch.where(keep, pos, cap)                      # overflow slot

    tok = torch.arange(T, device=x.device).repeat_interleave(k)
    slot = flat_e * (cap + 1) + safe_pos
    # under EP each rank's buffer holds its experts' tokens: the gradient's
    # fp32 partials summed over the ranks
    xt = pctx.to_model(x2.float()) if _expert_mode() == "ep" else x2
    buf = torch.zeros((E * (cap + 1), d), dtype=dt, device=x.device).index_add(
        0, slot, xt[tok].to(dt)).reshape(E, cap + 1, d)
    yout = _expert_ffn(p, buf[_experts(cfg), :cap][None], cfg, dt)[0]  # (E,cap,d)
    yout = torch.cat([yout, torch.zeros((E, 1, d), dtype=dt, device=x.device)], dim=1)
    gathered = yout[flat_e, safe_pos]                           # (T*k, d)
    gathered = torch.where(keep[:, None], gathered, torch.zeros_like(gathered))
    y = torch.zeros((T, d), dtype=torch.float32, device=x.device).index_add(
        0, tok, gathered.float() * w.reshape(-1)[:, None])
    return y.reshape(B, S, d).to(x.dtype), aux


def moe_apply(p, x, cfg, *, impl: str = "einsum", group_size: int = 512):
    if impl == "einsum":
        return moe_apply_einsum(p, x, cfg, group_size=group_size)
    if impl == "scatter":
        return moe_apply_scatter(p, x, cfg)
    raise ValueError(f"unknown moe impl {impl!r}; known: 'einsum', 'scatter'")
