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
copy), under TP within the experts by ``layers.whole_input``.

Under sequence parallelism (``parallel.ctx.seq_parallel()``) the block hands
``moe_apply`` this model rank's rows (``_routed``): the router, a product of
each token alone, runs on the rows, and its outputs and the tokens are
gathered into the data rank's whole sequence before the top-k choices are
queued, so that the dispatch groups, the capacity and the dropped choices are
one device's (on a rank's rows alone they would be other groups of other
sizes); the dispatch and the combine run as above, and each rank keeps its
rows of the output. Under EP the tokens are gathered in fp32 and each rank's
dispatch hands back its fp32 partial of their gradient, which the gather
reduce-scatters to the rows (``parallel.ctx.seq_gather_f32``) in place of
``_Dispatch``'s all-reduce. Under TP within the experts one device rounds the
slots' gradient before the dispatch's backward, so the slots' fp32 partials
are summed first: where the layout splits ``d_model``, by blocks of its
columns (``_DispatchRows``: a reduce-scatter, then an all-to-all of the
tokens' gradient into rows), else all-reduced (``layers.whole_input``) on
tokens gathered alike, as in the scatter dispatch and without the split.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
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


def _expert_ffn(p, xin, cfg, dt, *, sum_grad=True):
    """xin: (..., E, C, d) -> (..., E, C, d) through each expert's gated MLP.
    Under EP ``p`` holds this rank's experts and ``xin`` their slots, and the
    ranks' outputs are joined; under TP within the experts the products are
    ``layers.split_mm`` and ``layers.joined_mm``, and ``xin``'s gradient the
    ranks' fp32 partials summed (``layers.whole_input``), or without
    ``sum_grad`` (``xin`` fp32) this rank's, handed back to ``_DispatchRows``."""
    act = F.silu if cfg.mlp == "swiglu" else layers._gelu
    mode = _expert_mode()
    if mode == "tp":
        xs = layers.whole_input(xin) if sum_grad else xin
        h = act(layers.split_mm(xs, p["wg"].to(dt))) * layers.split_mm(xs, p["wu"].to(dt))
        return layers.joined_mm(h, p["wd"].to(dt), split=pctx.layout().d_model)
    g = torch.einsum("...ecd,edf->...ecf", xin, p["wg"].to(dt))
    u = torch.einsum("...ecd,edf->...ecf", xin, p["wu"].to(dt))
    y = torch.einsum("...ecf,efd->...ecd", act(g) * u, p["wd"].to(dt))
    return pctx.gather_from_model(y, -3) if mode == "ep" else y


class _Dispatch(torch.autograd.Function):
    """The dispatch einsum of this model rank's experts' slots, in ``disp``'s
    type: the tokens' gradient is the ranks' partials taken in fp32, summed
    over ``group`` and rounded once to ``xg``'s type; with no group
    (sequence parallelism, ``xg`` fp32) this rank's fp32 partial, for the
    tokens' gather to reduce-scatter."""

    @staticmethod
    def forward(ctx, disp, xg, group):
        ctx.save_for_backward(disp)
        ctx.group, ctx.x_dtype = group, xg.dtype
        return torch.einsum("ngec,ngd->necd", disp, xg.to(disp.dtype))

    @staticmethod
    def backward(ctx, dxin):
        disp, = ctx.saved_tensors
        part = torch.einsum("ngec,necd->ngd", disp.float(), dxin.float())
        if ctx.group is not None:
            part = pctx.all_reduce_f32(part, ctx.group)
        return None, part.to(ctx.x_dtype), None


class _DispatchRows(torch.autograd.Function):
    """Under sequence parallelism with TP within the experts and ``d_model``
    split: the dispatch einsum, in ``disp``'s type, of this model rank's rows
    ``x`` (B, S/tp, d) gathered into the data rank's whole sequence, widened
    to fp32 for the experts' split products. Its backward sums the slots'
    fp32 partials over the ranks by blocks of ``d`` (a reduce-scatter: this
    rank's block of columns), rounds them once to ``disp``'s type, as one
    device rounds the slots' gradient, runs the dispatch's backward on that
    block and turns the tokens' gradient columns into this rank's rows (an
    all-to-all)."""

    @staticmethod
    def forward(ctx, disp, x, group):
        ctx.save_for_backward(disp)
        ctx.group, ctx.shape, ctx.x_dtype = group, x.shape, x.dtype
        xg = pctx.all_gather(x, 1, group).reshape(*disp.shape[:2], -1)
        return torch.einsum("ngec,ngd->necd", disp, xg.to(disp.dtype)).float()

    @staticmethod
    def backward(ctx, dxin):
        disp, = ctx.saved_tensors
        n = dist.get_world_size(ctx.group)
        B, s, d = ctx.shape
        blocks = dxin.float().reshape(*dxin.shape[:-1], n, d // n).movedim(-2, 0).contiguous()
        mine = blocks.new_empty(blocks.shape[1:])
        dist.reduce_scatter_tensor(mine, blocks.flatten(0, 1), group=ctx.group)
        dxg = torch.einsum("ngec,necd->ngd", disp, mine.to(disp.dtype))
        rows = pctx.columns_to_rows(dxg.reshape(B, s * n, d // n), ctx.group)
        return None, rows.to(ctx.x_dtype), None


def _routed(p, x, cfg):
    """``_route``'s outputs for the tokens of ``x`` (B, S, d). Under sequence
    parallelism ``x`` is this model rank's rows: the router runs on them, and
    its outputs come back gathered, the data rank's whole sequence (the
    module's docstring)."""
    B, S, d = x.shape
    w, idx, probs = _route(p, x.reshape(B * S, d), cfg)
    if not pctx.seq_parallel():
        return w, idx, probs
    return (pctx.gather_from_model(t.reshape(B, S, -1), 1).reshape(-1, t.shape[-1])
            for t in (w, idx, probs))


def _tokens(x):
    """The tokens of ``x`` (B, S, d) as (T, d); under sequence parallelism the
    model ranks' rows gathered, under EP in fp32 (the dispatch hands back
    their gradient's fp32 partials), else alike."""
    if not pctx.seq_parallel():
        return x.reshape(-1, x.shape[-1])
    xs = pctx.seq_gather_f32(x) if _expert_mode() == "ep" else pctx.gather_from_model(x, 1)
    return xs.reshape(-1, x.shape[-1])


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
    other groups (a group of the reference's spans ranks). Under the serving
    scope (``parallel.ctx.serving_cache``, the sharded serving steps: a
    decode step's B slots are one group, C17) its tokens are gathered over
    the data ranks (``parallel.ctx.data_gather``), the global batch's groups
    routed and dispatched as one device does, and the rank keeps its rows of
    the output; outside it (training, with or without grad) it raises
    ``ValueError`` (ROADMAP C27). The load-balance loss is the rank's rows'
    term either way.
    """
    seq = pctx.seq_parallel()
    B, S, d = x.shape
    S *= pctx.model_size() if seq else 1              # the gathered sequence
    E, k = cfg.num_experts, cfg.experts_per_token
    dt = layers.to_dtype(cfg.compute_dtype)
    T = B * S
    own = B                                           # this data rank's rows
    span = T < group_size and pctx.data_size() > 1 and pctx.cache_block() is not None
    if span:                                          # one group over the data ranks
        x = pctx.data_gather(x)
        B = x.shape[0]
        T = B * S
    g = min(group_size, T)
    if T % g:
        raise ValueError(f"moe einsum dispatch: {T} tokens (B={B} x S={S}) do not "
                         f"split into groups of {g}")
    if T < group_size and pctx.data_size() > 1 and not span:
        raise ValueError(f"moe einsum dispatch: a data rank's {T} tokens are fewer than "
                         f"a group of {group_size}; the global batch's groups would span "
                         "ranks")
    n_grp = T // g
    w, idx, probs = _routed(p, x, cfg)
    if span:
        aux = aux_load_balance_loss(pctx.data_rows(probs, own * S),
                                    pctx.data_rows(idx, own * S), E)
    else:
        aux = aux_load_balance_loss(probs, idx, E)

    cap = max(1, int(g * k / E * cfg.capacity_factor))
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

    mode = _expert_mode()
    rows = seq and mode == "tp" and pctx.layout().d_model
    if rows:                                         # fp32 slots, their gradient partial
        xin = _DispatchRows.apply(disp, x, pctx.model_group())
    elif mode == "ep":                               # this rank's experts
        xg = _tokens(x).reshape(n_grp, g, d)
        xin = _Dispatch.apply(disp[:, :, _experts(cfg)], xg if seq else xg.to(dt),
                              None if seq else pctx.model_group())
    else:
        xin = torch.einsum("ngec,ngd->necd", disp, _tokens(x).reshape(n_grp, g, d).to(dt))
    xin = pctx.constrain(xin, "moe_tokens")                     # (n,E,cap,d)
    yout = pctx.constrain(_expert_ffn(p, xin, cfg, dt, sum_grad=not rows), "moe_tokens")
    y = torch.einsum("ngec,necd->ngd", comb, yout).reshape(B, S, d)
    return (pctx.data_rows(y, own) if span else y).to(x.dtype), aux


def moe_apply_scatter(p, x, cfg):
    """Dispatch without one-hot FLOPs: ``index_add`` into capacity buffers.

    All B * S tokens are one group, so inside ``parallel.ctx.data_parallel``
    (where the reference's group is the global batch's tokens) it raises
    ``ValueError`` over more than one data rank (ROADMAP C27)."""
    if pctx.data_size() > 1:
        raise ValueError("moe scatter dispatch: one group of the global batch's tokens "
                         "spans the data ranks; use the einsum dispatch")
    seq = pctx.seq_parallel()
    w, idx, probs = _routed(p, x, cfg)
    x2 = _tokens(x)
    B, d = x.shape[0], x.shape[-1]
    T = x2.shape[0]
    S = T // B
    E, k = cfg.num_experts, cfg.experts_per_token
    dt = layers.to_dtype(cfg.compute_dtype)
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
    # fp32 partials summed over the ranks (under sequence parallelism by the
    # tokens' gather, x2 fp32)
    xt = pctx.to_model(x2.float()) if _expert_mode() == "ep" and not seq else x2
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
    if impl not in ("einsum", "scatter"):
        raise ValueError(f"unknown moe impl {impl!r}; known: 'einsum', 'scatter'")
    if impl == "einsum":
        y, aux = moe_apply_einsum(p, x, cfg, group_size=group_size)
    else:
        y, aux = moe_apply_scatter(p, x, cfg)
    return pctx.seq_rows(y), aux      # this rank's rows under sequence parallelism
