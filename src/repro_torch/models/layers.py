"""Primitive layers: norms, linears, rotary embeddings, MLP blocks.

Parameters are plain nested dicts of tensors; every layer is a pair of a seeded
``*_init(gen, ...) -> params`` (``gen`` is a ``torch.Generator`` living on the
device the parameters are made on, or ``SHAPE_ONLY`` for tensors on the meta
device: shapes and dtypes, nothing drawn) and a pure apply function. Compute follows
``cfg.compute_dtype`` (bf16 by default) with fp32 norms.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

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


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def norm_init(kind: str, d: int, device="cpu"):
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
    if kind in ("swiglu", "geglu"):
        g = dense(p["wg"], x, dtype=dtype)
        act = F.silu(g) if kind == "swiglu" else _gelu(g)
        h = act * dense(p["wu"], x, dtype=dtype)
        return dense(p["wd"], h, dtype=dtype)
    h = _gelu(dense(p["wu"], x, dtype=dtype))
    return dense(p["wd"], h, dtype=dtype)


# ---------------------------------------------------------------------------
# Embedding
# ---------------------------------------------------------------------------

def embed_init(gen, vocab: int, d: int):
    return {"table": truncated_normal(gen, (vocab, d), 1.0 / math.sqrt(d))}


def embed(p, tokens, *, dtype=torch.bfloat16):
    # gather first, cast after: same values as casting the table, without
    # touching the whole table on every call
    return p["table"][tokens].to(dtype)
