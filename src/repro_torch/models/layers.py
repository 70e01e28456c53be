"""Primitive layers: norms, linears, rotary embeddings, MLP blocks.

Parameters are plain nested dicts of tensors; every layer is a pair of a seeded
``*_init(gen, ...) -> params`` (``gen`` is a ``torch.Generator`` living on the
device the parameters are made on, or ``SHAPE_ONLY`` for tensors on the meta
device: shapes and dtypes, nothing drawn) and a pure apply function. Compute follows
``cfg.compute_dtype`` (bf16 by default) with fp32 norms.

Inside ``parallel.ctx.model_parallel`` a layer is handed its ``model``
shard of the leaves that ``parallel.ctx.layout()`` splits and computes its
share, every product column-parallel: each output column is computed over the
whole contraction, as one device computes it. ``dense_split`` is a product on
this rank's columns of a weight (the MLP's ``wg`` / ``wu`` on its share of
``d_ff``); ``dense_joined`` the second product of a pair, on its share of the
output columns over the ranks' gathered inputs (``wd`` over the whole of
``d_ff``); ``dense_columns`` a product of an input every rank holds whole on
this rank's output columns, joined (a Mamba2 layer's ``out_proj``). Where a
sum over the model ranks remains (the gradient of a replicated input of
``dense_split``), each rank's partial products are taken in fp32 and the sum
rounded once, as one device rounds its product. The
embedding is vocabulary-parallel. Outside the scope every layer computes as
on one device.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.parallel import ctx as pctx

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def to_dtype(name) -> torch.dtype:
    return name if isinstance(name, torch.dtype) else DTYPES[name]


class ShapeOnly:
    """Stands where a ``torch.Generator`` would for a build on the meta device
    (no generator lives there): ``truncated_normal`` then draws nothing, and
    every ``*_init`` gives meta tensors of the seeded build's shapes and dtypes."""
    device = torch.device("meta")


SHAPE_ONLY = ShapeOnly()


def truncated_normal(gen: torch.Generator, shape, stddev: float,
                     dtype=torch.float32):
    if gen.device.type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    t = torch.empty(shape, dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(t, mean=0.0, std=1.0, a=-2.0, b=2.0,
                                generator=gen)
    return (stddev * t).to(dtype)


def dense_init(gen, d_in: int, d_out: int, *, bias: bool = False,
               dtype=torch.float32):
    p = {"w": truncated_normal(gen, (d_in, d_out), 1.0 / math.sqrt(d_in), dtype)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=gen.device)
    return p


def dense(p, x, *, dtype=torch.bfloat16):
    """``x @ w`` with ``w`` laid out ``(d_in, d_out)``.

    ``.to(dtype)`` returns the tensor itself when it already has that type, so
    weights cast once (``cast_params`` in ``models/transformer.py``) cost
    nothing here.
    """
    y = x.to(dtype) @ p["w"].to(dtype)
    if "b" in p:
        y = y + p["b"].to(dtype)
    return y


def mm_f32(a, b):
    """a @ b with fp32 products, sums and result, for 2-d operands or a batch
    of them (the experts: (E, R, K) @ (E, K, N)). The CPU has no kernel of
    ``torch.mm``'s ``out_dtype`` form, so it widens bf16 operands first (the
    same numbers); every other device (the card, meta) takes it, one expert
    at a time."""
    if a.dtype == torch.float32:
        return a @ b
    if a.device.type == "cpu":
        return a.float() @ b.float()
    if b.dim() == 2:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.stack([torch.mm(x, y, out_dtype=torch.float32) for x, y in zip(a, b)])


def _flat(x, w):
    """``x`` as the rows of ``x @ w``: 2-d for a matrix ``w``, (..., E, C, K)
    as (E, rows, K) for a batched one (the experts)."""
    if w.dim() == 2:
        return x.reshape(-1, x.shape[-1])
    return x.movedim(-3, 0).reshape(w.shape[0], -1, x.shape[-1])


def _unflat(y, x):
    """The product rows ``y`` of ``_flat(x, w)`` in ``x``'s layout."""
    if y.dim() == 2:
        return y.reshape(x.shape[:-1] + y.shape[-1:])
    return y.reshape(y.shape[:1] + x.shape[:-3] + x.shape[-2:-1] + y.shape[-1:]).movedim(0, -3)


def _rows_mm(x, w):
    """``x @ w`` by rows: for the experts one batched product over E, not a
    broadcast over ``x``'s leading dims (which would copy ``w`` for each)."""
    return x @ w if w.dim() == 2 else _unflat(_flat(x, w) @ w, x)


def _weight_grad(x, dy, w):
    """The gradient of ``w`` in ``y = x @ w``, over every row, in ``x``'s type."""
    return _flat(x, w).transpose(-1, -2) @ _flat(dy, w)


class _SplitMM(torch.autograd.Function):
    """``x @ w`` with ``x`` the fp32 copy of a compute-type input and ``w``
    this rank's columns (a matrix, or every expert's): the product as
    ``dense`` takes it, the input's gradient in fp32, unrounded."""

    @staticmethod
    def forward(ctx, x, w):
        xb = x.to(w.dtype)
        ctx.save_for_backward(xb, w)
        return _rows_mm(xb, w)

    @staticmethod
    def backward(ctx, dy):
        xb, w = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _unflat(mm_f32(_flat(dy, w), w.transpose(-1, -2)), xb)
        if ctx.needs_input_grad[1]:
            dw = _weight_grad(xb, dy, w)
        return dx, dw


class _JoinedMM(torch.autograd.Function):
    """The model ranks' blocks of ``x`` joined along the last dim, times ``w``
    (a matrix, or every expert's): this rank's output columns where ``split``
    (the ranks' columns then joined where ``join``, else this rank's kept),
    else the whole ``w``, alike on every rank. The gradient of ``x`` is taken
    in fp32 and rounded once: where ``split``, the ranks' partials over their
    columns reduce-scattered back to the blocks; else every rank holds the
    whole product's gradient and keeps its block, with nothing to sum."""

    @staticmethod
    def forward(ctx, x, w, split, join, group):
        xf = pctx.all_gather(x, -1, group)
        ctx.save_for_backward(xf, w)
        ctx.split, ctx.join, ctx.group = split, split and join, group
        y = _rows_mm(xf, w)
        return pctx.all_gather(y, -1, group) if ctx.join else y

    @staticmethod
    def backward(ctx, dy):
        xf, w = ctx.saved_tensors
        n, rank = dist.get_world_size(ctx.group), dist.get_rank(ctx.group)
        if ctx.join:
            dy = dy.chunk(n, dim=-1)[rank]
        dx = dw = None
        if ctx.needs_input_grad[0]:
            # (K, rows) or (K, E, rows): the contraction's blocks lead
            part = mm_f32(w, _flat(dy, w).transpose(-1, -2))
            if w.dim() == 3:
                part = part.movedim(1, 0).contiguous()
            if ctx.split:
                out = part.new_empty((part.shape[0] // n,) + part.shape[1:])
                dist.reduce_scatter_tensor(out, part, group=ctx.group)
            else:
                out = part.chunk(n, dim=0)[rank]
            # (rows, K/n) or (E, rows, K/n)
            dx = _unflat(out.movedim(0, -1).to(xf.dtype), xf)
        if ctx.needs_input_grad[1]:
            dw = _weight_grad(xf, dy, w)
        return dx, dw, None, None, None


def split_input(x):
    """The input of this model rank's ``dense_split`` products: an fp32 copy
    of ``x``, whose gradient (the products' fp32 partials, summed over the
    products and over the model ranks) is rounded once to ``x``'s type."""
    return pctx.to_model(x.float())


def split_mm(x, w):
    """``x @ w`` on this rank's columns of ``w`` from ``split_input``'s ``x``."""
    return _SplitMM.apply(x, w)


def joined_mm(x, w, *, split: bool, join: bool = True):
    """``x @ w`` for this rank's block ``x`` of the contraction (``_JoinedMM``)."""
    return _JoinedMM.apply(x, w, split, join, pctx.model_group())


def dense_split(p, x, *, dtype=torch.bfloat16):
    """``dense`` on this model rank's output columns of ``p`` (a ``model``
    shard) from ``split_input(x)``: each column is one device's."""
    y = split_mm(x, p["w"].to(dtype))
    if "b" in p:
        y = y + p["b"].to(dtype)
    return y


def dense_joined(p, x, *, dtype=torch.bfloat16):
    """The second product of a partitioned pair, each output column computed
    as one device computes it: ``x`` holds this model rank's block of the
    contraction (its heads, its share of ``d_ff``), gathered over the model
    ranks; ``p["w"]`` holds the whole contraction for this rank's block of the
    output columns where the layout splits ``d_model`` (the ranks then join
    them), else for all of them. The bias (whole) is added after."""
    y = joined_mm(x.to(dtype), p["w"].to(dtype), split=pctx.layout().d_model)
    if "b" in p:
        y = y + p["b"].to(dtype)
    return y


def dense_columns(p, x, *, dtype=torch.bfloat16):
    """``dense`` of an input ``x`` that every model rank holds whole, on this
    rank's block of the output columns (``p`` a ``model`` shard of them), the
    ranks' blocks then joined: each column is one device's, and the input's
    gradient is the ranks' fp32 partials summed and rounded once."""
    return pctx.gather_from_model(dense_split(p, split_input(x), dtype=dtype), -1)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def norm_init(kind: str, d: int, *, device):
    if kind == "rmsnorm":
        return {"scale": torch.ones((d,), dtype=torch.float32, device=device)}
    if kind == "layernorm":
        return {"scale": torch.ones((d,), dtype=torch.float32, device=device),
                "bias": torch.zeros((d,), dtype=torch.float32, device=device)}
    if kind == "nonparam_ln":  # OLMo: non-parametric LayerNorm
        return {}
    raise ValueError(kind)


def apply_norm(kind: str, p, x, eps: float = 1e-5):
    xf = x.float()
    if kind == "rmsnorm":
        y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
        y = y * p["scale"]
    else:
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
        if kind == "layernorm":
            y = y * p["scale"] + p["bias"]
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings (llama-style half rotation)
# ---------------------------------------------------------------------------

def rope(x, positions, theta: float):
    """x: (..., seq, heads, head_dim), positions: (..., seq)."""
    half = x.shape[-1] // 2
    freqs = torch.exp(-math.log(theta) * torch.arange(
        0, half, dtype=torch.float32, device=x.device) / half)
    ang = positions[..., :, None].to(torch.float32) * freqs  # (..., seq, half)
    cos = torch.cos(ang)[..., :, None, :]   # broadcast over heads
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP blocks
# ---------------------------------------------------------------------------

def mlp_init(gen, kind: str, d: int, d_ff: int, *, bias: bool = False):
    if kind in ("swiglu", "geglu"):
        return {
            "wg": dense_init(gen, d, d_ff, bias=bias),
            "wu": dense_init(gen, d, d_ff, bias=bias),
            "wd": dense_init(gen, d_ff, d, bias=bias),
        }
    if kind == "gelu_mlp":
        return {
            "wu": dense_init(gen, d, d_ff, bias=bias),
            "wd": dense_init(gen, d_ff, d, bias=bias),
        }
    raise ValueError(kind)


def _gelu(x):
    # the reference's gelu is the tanh approximation; torch defaults to erf
    return F.gelu(x, approximate="tanh")


def apply_mlp(kind: str, p, x, *, dtype=torch.bfloat16):
    """The MLP block. Where the layout splits ``d_ff``, ``wg`` / ``wu`` are
    ``dense_split`` (this rank's share of the hidden units) and ``wd`` is
    ``dense_joined``."""
    lay = pctx.layout()
    split = lay is not None and lay.d_ff
    first = dense_split if split else dense
    x = split_input(x) if split else x
    if kind in ("swiglu", "geglu"):
        g = first(p["wg"], x, dtype=dtype)
        act = F.silu(g) if kind == "swiglu" else _gelu(g)
        h = act * first(p["wu"], x, dtype=dtype)
    else:
        h = _gelu(first(p["wu"], x, dtype=dtype))
    return (dense_joined if split else dense)(p["wd"], h, dtype=dtype)


# ---------------------------------------------------------------------------
# Embedding
# ---------------------------------------------------------------------------

def embed_init(gen, vocab: int, d: int):
    return {"table": truncated_normal(gen, (vocab, d), 1.0 / math.sqrt(d))}


def embed(p, tokens, *, dtype=torch.bfloat16):
    """The tokens' rows of the table. Where the layout splits the vocabulary
    (the table a ``model`` shard of its rows), each model rank looks up the
    tokens in its rows, zeros the others, and the ranks' rows are summed
    (exactly: one rank's row is not zero)."""
    # gather first, cast after: same values as casting the table, without
    # touching the whole table on every call
    table = p["table"]
    lay = pctx.layout()
    if lay is None or not lay.vocab:
        return table[tokens].to(dtype)
    local = tokens.long() - pctx.model_index() * table.shape[0]
    own = ((local >= 0) & (local < table.shape[0]))[..., None]
    rows = table[torch.where(own[..., 0], local, 0)]
    return pctx.from_model(torch.where(own, rows, 0)).to(dtype)
