"""Attention: GQA projections + FlashAttention-style chunked online softmax.

``flash_ref`` is the plain-PyTorch online-softmax implementation (algorithmically
FlashAttention, looped over KV chunks). ``attn_apply`` sends self-attention to
the hand-written kernels through ``kernels.ops``: prefill to ``mha_forward``,
cached decode to ``decode_forward``.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import ops
from repro_torch.models import layers

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Reference implementations
# ---------------------------------------------------------------------------

def attention_naive(q, k, v, *, causal: bool, q_offset: int = 0):
    """Materializing reference. q:(B,L,H,D) k/v:(B,S,Hkv,D) -> (B,L,H,D)."""
    B, L, H, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    qg = q.reshape(B, L, Hkv, G, D)
    s = torch.einsum("blhgd,bshd->bhgls", qg.float(), k.float())
    s = s * (1.0 / math.sqrt(D))
    if causal:
        row = torch.arange(L, device=q.device)[:, None] + q_offset
        col = torch.arange(S, device=q.device)[None, :]
        s = torch.where(col <= row, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgls,bshd->blhgd", p, v.float())
    return o.reshape(B, L, H, D).to(q.dtype)


def flash_ref(q, k, v, *, causal: bool, q_offset: int = 0, chunk: int = 512,
              pv_bf16: bool = False):
    """Online-softmax attention looped over KV chunks (plain PyTorch).

    Never materializes the (L, S) score matrix for more than one KV chunk.
    ``pv_bf16`` rounds the probability tile and V to bf16 for the PV product
    (fp32 accumulation), as FA3 does before P@V.
    """
    B, L, H, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    chunk = min(chunk, S)
    dev = q.device
    qg = q.reshape(B, L, Hkv, G, D).float() * (1.0 / math.sqrt(D))
    row = torch.arange(L, device=dev)[:, None] + q_offset

    m = torch.full((B, L, Hkv, G), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, L, Hkv, G), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, L, Hkv, G, D), dtype=torch.float32, device=dev)
    for c0 in range(0, S, chunk):
        kj, vj = k[:, c0:c0 + chunk], v[:, c0:c0 + chunk]
        s = torch.einsum("blhgd,bchd->blhgc", qg, kj.float())
        if causal:
            col = c0 + torch.arange(kj.shape[1], device=dev)[None, :]
            mask = col > row                                      # (L, chunk)
            s = torch.where(mask[None, :, None, None, :],
                            torch.full_like(s, NEG_INF), s)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        if pv_bf16:
            # bf16 operands, fp32 accumulation: round both, multiply in fp32
            pv = torch.einsum("blhgc,bchd->blhgd", p.bfloat16().float(),
                              vj.bfloat16().float())
        else:
            pv = torch.einsum("blhgc,bchd->blhgd", p, vj.float())
        acc = acc * corr[..., None] + pv
        m = m_new
    o = acc / torch.clamp(l, min=1e-30)[..., None]
    return o.reshape(B, L, H, D).to(q.dtype)


def decode_attend(q, k_cache, v_cache, cache_len, *, q_offset=None):
    """Single-token decode over a (possibly longer-than-filled) KV cache.

    q: (B, 1, H, D); caches: (B, S_max, Hkv, D); cache_len: int, or (B,) tensor.
    Positions >= cache_len are masked.
    """
    B, L, H, D = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    G = H // Hkv
    qg = q.reshape(B, L, Hkv, G, D).float() * (1.0 / math.sqrt(D))
    s = torch.einsum("blhgd,bshd->blhgs", qg, k_cache.float())
    # (the sharding constraint the reference puts on the scores here has no
    # counterpart on one device)
    pos = torch.arange(S, device=q.device)
    clen = torch.as_tensor(cache_len, device=q.device).expand(B)
    valid = pos[None, :] < clen[:, None]
    s = torch.where(valid[:, None, None, None, :], s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    o = torch.einsum("blhgs,bshd->blhgd", p, v_cache.float())
    o = o / p.sum(dim=-1)[..., None]
    return o.reshape(B, L, H, D).to(q.dtype)


def decode_attend_partial(q, k_shard, v_shard, valid_mask):
    """Shard-local flash decode for sequence-sharded KV caches.

    Returns (o_partial(fp32), m(fp32), l(fp32)) for a log-sum-exp merge across
    sequence shards (see merge_partial_attn).
    q: (B,1,H,D); k/v_shard: (B,S_loc,Hkv,D); valid_mask: (B,S_loc) bool.
    """
    B, L, H, D = q.shape
    Hkv = k_shard.shape[2]
    G = H // Hkv
    qg = q.reshape(B, L, Hkv, G, D).float() * (1.0 / math.sqrt(D))
    s = torch.einsum("blhgd,bshd->blhgs", qg, k_shard.float())
    s = torch.where(valid_mask[:, None, None, None, :], s,
                    torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    o = torch.einsum("blhgs,bshd->blhgd", p, v_shard.float())
    return o, m, l


def merge_partial_attn(o_parts, m_parts, l_parts, axis: int = 0):
    """Merge per-shard (o, m, l) partials along a leading shard axis."""
    m = m_parts.amax(dim=axis)
    corr = torch.exp(m_parts - m.unsqueeze(axis))
    l = (l_parts * corr).sum(dim=axis)
    o = (o_parts * corr[..., None]).sum(dim=axis)
    return o / torch.clamp(l, min=1e-30)[..., None]


# ---------------------------------------------------------------------------
# Attention block (projections + rope + cache plumbing)
# ---------------------------------------------------------------------------

def attn_init(gen, cfg):
    d, hd = cfg.d_model, cfg.head_dim
    qkv_bias = cfg.qkv_bias or cfg.bias
    return {
        "wq": layers.dense_init(gen, d, cfg.num_heads * hd, bias=qkv_bias),
        "wk": layers.dense_init(gen, d, cfg.num_kv_heads * hd, bias=qkv_bias),
        "wv": layers.dense_init(gen, d, cfg.num_kv_heads * hd, bias=qkv_bias),
        "wo": layers.dense_init(gen, cfg.num_heads * hd, d, bias=cfg.bias),
    }


def attn_apply(p, x, cfg, *, positions, kv_cache=None, cache_index=None,
               cross_kv=None, attn_fn=None, use_rope=True, mode=None):
    """Returns (out, new_kv) where new_kv is (k, v) of this call's tokens.

    kv_cache: optional (k_cache, v_cache) of shape (B, S_max, Hkv, D) -- decode
    path (x is (B,1,d)). The new token's K and V are written into these tensors
    **in place** at ``cache_index`` (a host int), and the same tensors are
    returned. cross_kv: precomputed (k, v) for cross-attention (no rope, no
    cache write). ``mode`` is handed to ``kernels.ops``.
    """
    B, L, _ = x.shape
    H, Hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dt = layers.to_dtype(cfg.compute_dtype)
    q = layers.dense(p["wq"], x, dtype=dt).reshape(B, L, H, hd)
    if cross_kv is not None:
        k, v = cross_kv
        if use_rope:
            q = layers.rope(q, positions, cfg.rope_theta)
        # non-causal with L != S in general, and on no serving path yet: stays
        # on the plain online softmax
        o = (attn_fn or flash_ref)(q, k, v, causal=False)
        return layers.dense(p["wo"], o.reshape(B, L, H * hd), dtype=dt), None

    k = layers.dense(p["wk"], x, dtype=dt).reshape(B, L, Hkv, hd)
    v = layers.dense(p["wv"], x, dtype=dt).reshape(B, L, Hkv, hd)
    if use_rope:
        q = layers.rope(q, positions, cfg.rope_theta)
        k = layers.rope(k, positions, cfg.rope_theta)

    if kv_cache is not None:
        k_cache, v_cache = kv_cache
        idx = int(cache_index)
        k_cache[:, idx:idx + L] = k.to(k_cache.dtype)
        v_cache[:, idx:idx + L] = v.to(v_cache.dtype)
        o = ops.decode_forward(q, k_cache, v_cache, idx + L, mode=mode)
        out = layers.dense(p["wo"], o.reshape(B, L, H * hd), dtype=dt)
        return out, (k_cache, v_cache)

    if attn_fn is not None:
        o = attn_fn(q, k, v, causal=cfg.causal)
    else:
        o = ops.mha_forward(q, k, v, causal=cfg.causal, mode=mode)
    out = layers.dense(p["wo"], o.reshape(B, L, H * hd), dtype=dt)
    # (the reference constrains the collected K/V's sharding here; one device
    # has nothing to constrain)
    return out, (k, v)
