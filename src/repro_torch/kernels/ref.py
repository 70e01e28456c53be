"""Materialising oracles for the attention kernels (plain PyTorch)."""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def flash_attention_ref(q, k, v, *, causal: bool = True):
    """q: (B,H,L,D); k/v: (B,Hkv,S,D). Materializing softmax reference."""
    B, H, L, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    G = H // Hkv
    qg = q.reshape(B, Hkv, G, L, D).float()
    s = torch.einsum("bhgld,bhsd->bhgls", qg, k.float())
    s = s * (1.0 / math.sqrt(D))
    if causal:
        mask = (torch.arange(S, device=q.device)[None, :]
                > torch.arange(L, device=q.device)[:, None])
        s = torch.where(mask[None, None, None], torch.full_like(s, NEG_INF), s)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgls,bhsd->bhgld", p, v.float())
    return o.reshape(B, H, L, D).to(q.dtype)


def flash_decode_ref(q, k_cache, v_cache, cache_len):
    """q: (B,H,D); caches: (B,Hkv,S,D); cache_len: int, or (B,) tensor."""
    B, H, D = q.shape
    Hkv, S = k_cache.shape[1], k_cache.shape[2]
    G = H // Hkv
    qg = q.reshape(B, Hkv, G, D).float()
    s = torch.einsum("bhgd,bhsd->bhgs", qg, k_cache.float())
    s = s * (1.0 / math.sqrt(D))
    clen = torch.as_tensor(cache_len, device=q.device).reshape(-1, 1)
    valid = torch.arange(S, device=q.device)[None, :] < clen
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgs,bhsd->bhgd", p, v_cache.float())
    return o.reshape(B, H, D).to(q.dtype)
