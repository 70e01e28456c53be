"""LM-family model assembly. This slice of the port holds the dense family.

Blocks are a Python list of per-layer parameter dicts and the stacks are Python
loops over it. The other families (moe, vlm, hybrid, ssm) are not ported yet and
raise ``NotImplementedError`` naming the family.

Public API (used by serve/ and launch/):
    init_lm(cfg, gen)                       -> params
    cast_params(cfg, params)                -> params with matmul weights cast once
    apply_lm(cfg, params, tokens, ...)      -> (hidden, aux, kvs|None)
    prefill_lm(cfg, params, tokens, ...)    -> (hidden, cache)
    decode_lm(cfg, params, cache, tokens)   -> (logits, cache)      1 new token
    init_cache(cfg, batch, max_seq)         -> cache dict
    unembed(cfg, params, hidden)            -> logits

The cache is ``{"k", "v": (L, B, S_max, Hkv, hd), "idx": int}``. ``idx`` is a
host int (reading a device scalar back every step would synchronise), and
``decode_lm`` updates ``k``, ``v`` and ``idx`` **in place**: the cache it
returns is the one it was given.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models import attention, layers

PORTED_FAMILIES = ("dense",)
_NORM_KEYS = ("attn_norm", "mlp_norm", "final_norm")


def _require_ported(cfg):
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"model family {cfg.family!r} ({cfg.name}) is not ported to "
            f"repro_torch yet; ported: {PORTED_FAMILIES}")


# ---------------------------------------------------------------------------
# Per-layer blocks
# ---------------------------------------------------------------------------

def _block_init(gen, cfg):
    dev = gen.device
    return {
        "attn_norm": layers.norm_init(cfg.norm, cfg.d_model, dev),
        "attn": attention.attn_init(gen, cfg),
        "mlp_norm": layers.norm_init(cfg.norm, cfg.d_model, dev),
        "mlp": layers.mlp_init(gen, cfg.mlp, cfg.d_model, cfg.d_ff, bias=cfg.bias),
    }


def _block_apply(p, x, cfg, *, positions, kv=None, cache_index=None,
                 attn_fn=None, mode=None):
    h = layers.apply_norm(cfg.norm, p["attn_norm"], x)
    h, new_kv = attention.attn_apply(
        p["attn"], h, cfg, positions=positions, kv_cache=kv,
        cache_index=cache_index, attn_fn=attn_fn, mode=mode)
    x = x + h
    h = layers.apply_norm(cfg.norm, p["mlp_norm"], x)
    # on purpose not as the reference, whose block runs the MLP at apply_mlp's
    # default type (bf16) whatever cfg.compute_dtype says: here it follows the
    # config. Every shipped config computes in bf16, where the two agree.
    h = layers.apply_mlp(cfg.mlp, p["mlp"], h,
                         dtype=layers.to_dtype(cfg.compute_dtype))
    return x + h, new_kv, 0.0


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_lm(cfg, gen: torch.Generator):
    """Seeded parameters in fp32, on the generator's device."""
    _require_ported(cfg)
    params = {"emb": layers.embed_init(gen, cfg.vocab_size, cfg.d_model),
              "final_norm": layers.norm_init(cfg.norm, cfg.d_model, gen.device)}
    if not cfg.tie_embeddings:
        params["unembed"] = layers.dense_init(gen, cfg.d_model, cfg.vocab_size)
    params["blocks"] = [_block_init(gen, cfg) for _ in range(cfg.num_layers)]
    return params


def cast_params(cfg, params, dtype=None, device=None):
    """Matmul weights, biases and the embedding table cast once to the compute type.

    ``layers.dense`` casts its weight on every call; eagerly that would re-cast
    every weight at every step. Cast once, the per-call cast is the identity and
    the numbers are the same. Norm scales stay fp32 (``apply_norm`` multiplies
    in fp32). With ``device`` every leaf is also moved there.
    """
    dt = layers.to_dtype(dtype or cfg.compute_dtype)

    def walk(node, to):
        if isinstance(node, dict):
            return {k: walk(v, None if k in _NORM_KEYS else to)
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v, to) for v in node]
        if to is None or not torch.is_floating_point(node):
            return node if device is None else node.to(device)
        return node.to(device=device, dtype=to)

    return walk(params, dt)


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------

def init_cache(cfg, batch: int, max_seq: int, dtype=torch.bfloat16, device="cpu"):
    _require_ported(cfg)
    hd, hkv = cfg.head_dim, cfg.num_kv_heads
    shape = (cfg.num_layers, batch, max_seq, hkv, hd)
    dt = layers.to_dtype(dtype)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device),
            "idx": 0}


# ---------------------------------------------------------------------------
# forward passes
# ---------------------------------------------------------------------------

def _embed_inputs(cfg, params, tokens, embeds):
    x = layers.embed(params["emb"], tokens, dtype=layers.to_dtype(cfg.compute_dtype))
    if embeds is not None:  # precomputed prefix embeddings
        x = torch.cat([embeds.to(x.dtype), x], dim=1)
    return x


def apply_lm(cfg, params, tokens, *, embeds=None, attn_fn=None,
             remat: str = "full", collect_kv: bool = False, mode=None):
    """Prefill forward. Returns (hidden, aux, kv list|None).

    ``remat`` is accepted and ignored: there is no backward in this port yet.
    """
    _require_ported(cfg)
    x = _embed_inputs(cfg, params, tokens, embeds)
    S = x.shape[1]
    positions = torch.arange(S, device=x.device)[None, :]
    aux = 0.0
    kvs = [] if collect_kv else None
    for blk in params["blocks"]:
        x, kv, a = _block_apply(blk, x, cfg, positions=positions,
                                attn_fn=attn_fn, mode=mode)
        aux = aux + a
        if collect_kv:
            kvs.append(kv)
    x = layers.apply_norm(cfg.norm, params["final_norm"], x)
    return x, aux, kvs


def unembed(cfg, params, hidden):
    dt = layers.to_dtype(cfg.compute_dtype)
    if cfg.tie_embeddings:
        return hidden.to(dt) @ params["emb"]["table"].to(dt).T
    return layers.dense(params["unembed"], hidden, dtype=dt)


def prefill_lm(cfg, params, tokens, *, embeds=None, attn_fn=None,
               max_seq: Optional[int] = None, remat: str = "full", mode=None):
    """Forward + build decode cache. Returns (hidden, cache)."""
    hidden, _, kvs = apply_lm(cfg, params, tokens, embeds=embeds,
                              attn_fn=attn_fn, remat=remat, collect_kv=True,
                              mode=mode)
    B, S = tokens.shape[0], hidden.shape[1]
    max_seq = max_seq or S
    cache = init_cache(cfg, B, max_seq, dtype=cfg.compute_dtype,
                       device=hidden.device)
    for i, (k, v) in enumerate(kvs):
        cache["k"][i, :, :S] = k.to(cache["k"].dtype)
        cache["v"][i, :, :S] = v.to(cache["v"].dtype)
    cache["idx"] = S
    return hidden, cache


def decode_lm(cfg, params, cache, tokens, *, mode=None):
    """One decode step. tokens: (B, 1). Returns (logits, cache), cache updated in place."""
    _require_ported(cfg)
    x = _embed_inputs(cfg, params, tokens, None)
    idx = int(cache["idx"])
    positions = torch.full((1, 1), idx, dtype=torch.int64, device=x.device)
    for i, blk in enumerate(params["blocks"]):
        x, _, _ = _block_apply(blk, x, cfg, positions=positions,
                               kv=(cache["k"][i], cache["v"][i]),
                               cache_index=idx, mode=mode)
    cache["idx"] = idx + 1
    x = layers.apply_norm(cfg.norm, params["final_norm"], x)
    return unembed(cfg, params, x), cache
