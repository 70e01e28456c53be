"""Encoder-decoder (Whisper-large-v3 backbone). The conv / mel front end is a
stub: the encoder consumes precomputed frame embeddings (B, S_enc, d).

Blocks are Python lists of per-layer parameter dicts, as in
``models/transformer.py``; under grad, ``remat`` checkpoints each block as
there. Every attention goes to the hand-written kernels through
``kernels.ops``: the encoder's self-attention non-causal at L = S = S_enc, the
decoder's causal (its KV cache when decoding), and the cross-attention
non-causal at L != S, or as one token against the cached encoder rows in a
decode step (``attention.cross_attend``). Inside
``parallel.ctx.model_parallel`` the attentions and MLPs split as
``attention.attn_apply`` and ``layers.apply_mlp`` read the layout, the
cross-attention's K/V project the encoder output on the kv heads of the
rank's q heads (``attention.project_cross_kv``), and ``pos_dec`` and the norms
run whole on every rank.

The cache is ``{"k", "v": (dec_layers, B, S_max, Hkv, hd), "cross_k",
"cross_v": (dec_layers, B, S_enc, Hkv, hd), "idx": int}``: ``idx`` is a host
int, and ``decode_encdec`` writes the new K/V rows into ``k`` / ``v`` in place
and returns the cache it was given.
"""
from __future__ import annotations

from functools import partial

import torch

from repro_torch.models import attention, layers
from repro_torch.models.transformer import _checkpointed
from repro_torch.parallel import ctx as pctx

POS_DEC_ROWS = 65536   # rows of the decoder's learned position table


def _enc_block_init(gen, cfg):
    dev = gen.device
    return {
        "attn_norm": layers.norm_init(cfg.norm, cfg.d_model, device=dev),
        "attn": attention.attn_init(gen, cfg),
        "mlp_norm": layers.norm_init(cfg.norm, cfg.d_model, device=dev),
        "mlp": layers.mlp_init(gen, cfg.mlp, cfg.d_model, cfg.d_ff, bias=cfg.bias),
    }


def _dec_block_init(gen, cfg):
    p = _enc_block_init(gen, cfg)
    p["xattn_norm"] = layers.norm_init(cfg.norm, cfg.d_model, device=gen.device)
    p["xattn"] = attention.attn_init(gen, cfg)
    return p


def init_encdec(cfg, gen: torch.Generator):
    """Seeded parameters in fp32, on the generator's device."""
    dev = gen.device
    return {
        "emb": layers.embed_init(gen, cfg.vocab_size, cfg.d_model),
        "pos_dec": layers.truncated_normal(gen, (POS_DEC_ROWS, cfg.d_model), 0.01),
        "enc_blocks": [_enc_block_init(gen, cfg) for _ in range(cfg.enc_layers)],
        "dec_blocks": [_dec_block_init(gen, cfg) for _ in range(cfg.dec_layers)],
        "enc_norm": layers.norm_init(cfg.norm, cfg.d_model, device=dev),
        "dec_norm": layers.norm_init(cfg.norm, cfg.d_model, device=dev),
    }


def _mlp(cfg, blk, h):
    # the MLP follows cfg.compute_dtype, as the dense block's does (a deviation
    # on purpose: the reference's runs in bf16 whatever the config says)
    m = layers.apply_norm(cfg.norm, blk["mlp_norm"], h)
    return h + layers.apply_mlp(cfg.mlp, blk["mlp"], m,
                                dtype=layers.to_dtype(cfg.compute_dtype))


def _enc_block(blk, h, cfg, *, positions, attn_fn=None, mode=None):
    a = layers.apply_norm(cfg.norm, blk["attn_norm"], h)
    a, _ = attention.attn_apply(blk["attn"], a, cfg, positions=positions,
                                attn_fn=attn_fn, use_rope=False, causal=False, mode=mode)
    return _mlp(cfg, blk, h + a)


def encode(cfg, params, frames, *, attn_fn=None, remat="full", mode=None):
    """frames: (B, S_enc, d) precomputed frame embeddings (stub front end).
    The whisper encoder attends bidirectionally (non-causal); an ``attn_fn`` is
    called with ``causal=False`` too."""
    x = frames.to(layers.to_dtype(cfg.compute_dtype))
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    block = _checkpointed(partial(_enc_block, cfg=cfg, positions=positions,
                                  attn_fn=attn_fn, mode=mode), remat)
    for blk in params["enc_blocks"]:
        x = pctx.constrain(block(blk, x))
    return layers.apply_norm(cfg.norm, params["enc_norm"], x)


def _dec_block(blk, h, cfg, enc_kv, *, positions, kv=None, cache_index=None,
               attn_fn=None, mode=None):
    a = layers.apply_norm(cfg.norm, blk["attn_norm"], h)
    a, new_kv = attention.attn_apply(blk["attn"], a, cfg, positions=positions,
                                     kv_cache=kv, cache_index=cache_index,
                                     attn_fn=attn_fn, use_rope=False, mode=mode)
    h = h + a
    # the cross-attention takes no attn_fn, as in the reference
    xa = layers.apply_norm(cfg.norm, blk["xattn_norm"], h)
    xa, _ = attention.attn_apply(blk["xattn"], xa, cfg, positions=positions,
                                 cross_kv=enc_kv, use_rope=False, mode=mode)
    return _mlp(cfg, blk, h + xa), new_kv


def _cross_kv(cfg, blk, enc_h):
    return attention.project_cross_kv(blk["xattn"], enc_h, cfg)


def _embed_dec(cfg, params, tokens, start: int):
    """Token embeddings plus the position rows ``start, start + 1, ...``."""
    x = layers.embed(params["emb"], tokens, dtype=layers.to_dtype(cfg.compute_dtype))
    S = tokens.shape[1]
    return x + params["pos_dec"][start:start + S].to(x.dtype)[None]


def _dec_train_block(blk, h, enc_h, cfg, *, positions, attn_fn, mode):
    h, _ = _dec_block(blk, h, cfg, _cross_kv(cfg, blk, enc_h), positions=positions,
                      attn_fn=attn_fn, mode=mode)
    return h


def decode_train(cfg, params, tokens, enc_h, *, attn_fn=None, remat="full", mode=None):
    """Teacher-forced decoder pass. Returns hidden (B, S_dec, d)."""
    x = _embed_dec(cfg, params, tokens, 0)
    positions = torch.arange(tokens.shape[1], device=x.device)[None, :]
    block = _checkpointed(partial(_dec_train_block, cfg=cfg, positions=positions,
                                  attn_fn=attn_fn, mode=mode), remat)
    for blk in params["dec_blocks"]:
        x = pctx.constrain(block(blk, x, enc_h))
    return layers.apply_norm(cfg.norm, params["dec_norm"], x)


def unembed(cfg, params, hidden):
    dt = layers.to_dtype(cfg.compute_dtype)
    return hidden.to(dt) @ params["emb"]["table"].to(dt).T


def apply_encdec(cfg, params, frames, tokens, *, attn_fn=None, remat="full", mode=None):
    enc_h = encode(cfg, params, frames, attn_fn=attn_fn, remat=remat, mode=mode)
    hidden = decode_train(cfg, params, tokens, enc_h, attn_fn=attn_fn, remat=remat,
                          mode=mode)
    return unembed(cfg, params, hidden)


# ---------------------------------------------------------------------------
# serving: prefill + single-token decode with a self cache and fixed cross K/V
# ---------------------------------------------------------------------------

def init_dec_cache(cfg, batch, max_seq, s_enc, dtype=torch.bfloat16, *, device):
    shape = (cfg.dec_layers, batch, max_seq, cfg.num_kv_heads, cfg.head_dim)
    cross = (cfg.dec_layers, batch, s_enc, cfg.num_kv_heads, cfg.head_dim)
    dt = layers.to_dtype(dtype)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device),
            "cross_k": torch.zeros(cross, dtype=dt, device=device),
            "cross_v": torch.zeros(cross, dtype=dt, device=device),
            "idx": 0}


def _prefill_block(blk, h, enc_h, cfg, *, positions, mode):
    ekv = _cross_kv(cfg, blk, enc_h)
    h, kv = _dec_block(blk, h, cfg, ekv, positions=positions, mode=mode)
    return h, kv, ekv


def prefill_encdec(cfg, params, frames, tokens, *, max_seq=None, remat="full", mode=None):
    """Encodes ``frames``, runs the decoder over ``tokens`` and fills the cache.
    Takes no ``attn_fn``, as the reference's. Returns (hidden, cache)."""
    enc_h = encode(cfg, params, frames, remat=remat, mode=mode)
    B, S = tokens.shape
    cache = init_dec_cache(cfg, B, max_seq or S, enc_h.shape[1],
                           dtype=cfg.compute_dtype, device=enc_h.device)
    x = _embed_dec(cfg, params, tokens, 0)
    positions = torch.arange(S, device=x.device)[None, :]
    block = _checkpointed(partial(_prefill_block, cfg=cfg, positions=positions, mode=mode),
                          remat)
    for i, blk in enumerate(params["dec_blocks"]):
        x, (k, v), (ck, cv) = block(blk, x, enc_h)
        x = pctx.constrain(x)
        cache["k"][i, :, :S] = k.to(cache["k"].dtype)
        cache["v"][i, :, :S] = v.to(cache["v"].dtype)
        cache["cross_k"][i] = ck.to(cache["cross_k"].dtype)
        cache["cross_v"][i] = cv.to(cache["cross_v"].dtype)
    cache["idx"] = S
    return layers.apply_norm(cfg.norm, params["dec_norm"], x), cache


def decode_encdec(cfg, params, cache, tokens, *, mode=None):
    """tokens: (B, 1). The cross-attention reads the cached encoder projections.
    Returns (logits, cache), the cache updated in place."""
    idx = int(cache["idx"])
    x = _embed_dec(cfg, params, tokens, idx)
    positions = torch.full((1, 1), idx, dtype=torch.int64, device=x.device)
    for i, blk in enumerate(params["dec_blocks"]):
        x, _ = _dec_block(blk, x, cfg, (cache["cross_k"][i], cache["cross_v"][i]),
                          positions=positions, kv=(cache["k"][i], cache["v"][i]),
                          cache_index=idx, mode=mode)
        x = pctx.constrain(x, "residual_dec")
    cache["idx"] = idx + 1
    x = layers.apply_norm(cfg.norm, params["dec_norm"], x)
    return unembed(cfg, params, x), cache
