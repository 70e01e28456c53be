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

Under sequence parallelism each stack splits by its own length: the encoder
runs inside ``parallel.ctx.stack("encoder")`` (its checkpointed blocks too),
where ``parallel.ctx.seq_parallel()`` answers for the frames. A split stack
holds this model rank's rows between blocks, as ``apply_lm``'s residual: the
encoder takes its rows of the frames and its output is gathered once a step,
alike on every rank, before the decoder's blocks project it; the decoder
embeds its rows, ``pos_dec``'s rows taken from the whole sequence's.

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


def init_encdec(cfg, gen: torch.Generator, place=None):
    """Seeded parameters in fp32, on the generator's device. ``place(key,
    part)`` as ``transformer.init_lm``'s: the parts in the draws' order are
    ``"emb"``, ``"pos_dec"``, each layer of ``"enc_blocks"`` and of
    ``"dec_blocks"``, ``"enc_norm"`` and ``"dec_norm"``."""
    dev = gen.device
    keep = place or (lambda key, part: part)
    return {
        "emb": keep("emb", layers.embed_init(gen, cfg.vocab_size, cfg.d_model)),
        "pos_dec": keep("pos_dec", layers.truncated_normal(gen, (POS_DEC_ROWS, cfg.d_model),
                                                           0.01)),
        "enc_blocks": [keep("enc_blocks", _enc_block_init(gen, cfg))
                       for _ in range(cfg.enc_layers)],
        "dec_blocks": [keep("dec_blocks", _dec_block_init(gen, cfg))
                       for _ in range(cfg.dec_layers)],
        "enc_norm": keep("enc_norm", layers.norm_init(cfg.norm, cfg.d_model, device=dev)),
        "dec_norm": keep("dec_norm", layers.norm_init(cfg.norm, cfg.d_model, device=dev)),
    }


def _mlp(cfg, blk, h):
    # the MLP follows cfg.compute_dtype, as the dense block's does (a deviation
    # on purpose: the reference's runs in bf16 whatever the config says)
    m = layers.apply_norm(cfg.norm, blk["mlp_norm"], h)
    return h + layers.apply_mlp(cfg.mlp, blk["mlp"], m,
                                dtype=layers.to_dtype(cfg.compute_dtype))


def _enc_block(blk, h, cfg, *, positions, attn_fn=None, mode=None):
    with pctx.stack("encoder"):
        a = layers.apply_norm(cfg.norm, blk["attn_norm"], h)
        a, _ = attention.attn_apply(blk["attn"], a, cfg, positions=positions,
                                    attn_fn=attn_fn, use_rope=False, causal=False,
                                    mode=mode)
        return _mlp(cfg, blk, h + a)


def encode(cfg, params, frames, *, attn_fn=None, remat="full", mode=None):
    """frames: (B, S_enc, d) precomputed frame embeddings (stub front end).
    The whisper encoder attends bidirectionally (non-causal); an ``attn_fn`` is
    called with ``causal=False`` too. Returns the whole sequence's output,
    under sequence parallelism too (the module's docstring)."""
    with pctx.stack("encoder"):
        x = pctx.seq_rows(frames.to(layers.to_dtype(cfg.compute_dtype)))
        positions = torch.arange(frames.shape[1], device=x.device)[None, :]
        block = _checkpointed(partial(_enc_block, cfg=cfg, positions=positions,
                                      attn_fn=attn_fn, mode=mode), remat)
        for blk in params["enc_blocks"]:
            x = pctx.constrain(block(blk, x))
        return pctx.seq_gather(layers.apply_norm(cfg.norm, params["enc_norm"], x))


def _dec_block(blk, h, cfg, enc_kv, *, positions, kv=None, cache_index=None,
               cross_block=None, attn_fn=None, mode=None):
    a = layers.apply_norm(cfg.norm, blk["attn_norm"], h)
    a, new_kv = attention.attn_apply(blk["attn"], a, cfg, positions=positions,
                                     kv_cache=kv, cache_index=cache_index,
                                     attn_fn=attn_fn, use_rope=False, mode=mode)
    h = h + a
    # the cross-attention takes no attn_fn, as in the reference
    xa = layers.apply_norm(cfg.norm, blk["xattn_norm"], h)
    xa, _ = attention.attn_apply(blk["xattn"], xa, cfg, positions=positions,
                                 cross_kv=enc_kv, cross_block=cross_block, use_rope=False,
                                 mode=mode)
    return _mlp(cfg, blk, h + xa), new_kv


def _cross_kv(cfg, blk, enc_h):
    return attention.project_cross_kv(blk["xattn"], enc_h, cfg)


def _embed_dec(cfg, params, tokens, start: int):
    """Token embeddings plus the position rows ``start, start + 1, ...``; under
    sequence parallelism this model rank's rows of them."""
    x = layers.embed(params["emb"], tokens, dtype=layers.to_dtype(cfg.compute_dtype),
                     rows=pctx.seq_parallel())
    S = tokens.shape[1]
    return x + pctx.seq_rows(params["pos_dec"][start:start + S].to(x.dtype)[None])


def _dec_train_block(blk, h, enc_h, cfg, *, positions, attn_fn, mode):
    h, _ = _dec_block(blk, h, cfg, _cross_kv(cfg, blk, enc_h), positions=positions,
                      attn_fn=attn_fn, mode=mode)
    return h


def decode_train(cfg, params, tokens, enc_h, *, attn_fn=None, remat="full", mode=None):
    """Teacher-forced decoder pass over the whole ``enc_h``. Returns hidden
    (B, S_dec, d); under sequence parallelism this model rank's rows."""
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

def init_dec_cache(cfg, batch, max_seq, s_enc, dtype=torch.bfloat16, *, device,
                   kv_heads=None, cross_heads=None):
    """An empty cache; ``kv_heads`` / ``cross_heads`` (``cfg.num_kv_heads``
    by default) are the kv heads of a rank's self / cross block
    (``parallel.sharding.CacheBlock``)."""
    shape = (cfg.dec_layers, batch, max_seq, kv_heads or cfg.num_kv_heads, cfg.head_dim)
    cross = (cfg.dec_layers, batch, s_enc, cross_heads or cfg.num_kv_heads, cfg.head_dim)
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
    Takes no ``attn_fn``, as the reference's. Returns (hidden, cache).

    Inside ``parallel.ctx.serving_cache`` the cache is this rank's blocks
    (``parallel.sharding.CacheBlock``), as ``transformer.prefill_lm``'s:
    the self cache's block of its batch rows, kv heads and ``max_seq``
    positions, and the cross cache's (``block.cross``) of the kv heads the
    rank's q heads project (``attention.project_cross_kv``) and of the
    encoder's positions, which split where the heads do not. Under sequence
    parallelism (the sharded prefill's ``seq_split``, each stack by its own
    length) the cross K/V come from the encoder output gathered once and
    the self K/V from each attention's gathered sequence, so both caches are
    filled as without the split, and the hidden state returned is this model
    rank's rows of the decoder's."""
    enc_h = encode(cfg, params, frames, remat=remat, mode=mode)
    B, S = tokens.shape
    max_seq = max_seq or S
    s_enc = enc_h.shape[1]
    block = pctx.cache_block()
    first, count, heads, cross, cross_heads = 0, max_seq, None, (0, s_enc), None
    if block is not None:
        (first, count), heads = block.seq, block.heads[1]
        cross, cross_heads = block.cross.seq, block.cross.heads[1]
    cache = init_dec_cache(cfg, B, count, cross[1], dtype=cfg.compute_dtype,
                           device=enc_h.device, kv_heads=heads, cross_heads=cross_heads)
    n = min(max(S - first, 0), count)             # the prompt's rows in the self block
    x = _embed_dec(cfg, params, tokens, 0)
    positions = torch.arange(S, device=x.device)[None, :]
    block_fn = _checkpointed(partial(_prefill_block, cfg=cfg, positions=positions, mode=mode),
                             remat)
    c0, c1 = cross[0], cross[0] + cross[1]
    for i, blk in enumerate(params["dec_blocks"]):
        x, (k, v), (ck, cv) = block_fn(blk, x, enc_h)
        x = pctx.constrain(x)
        cache["k"][i, :, :n] = k[:, first:first + n].to(cache["k"].dtype)
        cache["v"][i, :, :n] = v[:, first:first + n].to(cache["v"].dtype)
        cache["cross_k"][i] = ck[:, c0:c1].to(cache["cross_k"].dtype)
        cache["cross_v"][i] = cv[:, c0:c1].to(cache["cross_v"].dtype)
    cache["idx"] = S
    return layers.apply_norm(cfg.norm, params["dec_norm"], x), cache


def decode_encdec(cfg, params, cache, tokens, *, mode=None):
    """tokens: (B, 1). The cross-attention reads the cached encoder projections
    (inside ``parallel.ctx.serving_cache``, the rank's ``block.cross``).
    Returns (logits, cache), the cache updated in place."""
    idx = int(cache["idx"])
    x = _embed_dec(cfg, params, tokens, idx)
    positions = torch.full((1, 1), idx, dtype=torch.int64, device=x.device)
    block = pctx.cache_block()
    cross = None if block is None else block.cross
    for i, blk in enumerate(params["dec_blocks"]):
        x, _ = _dec_block(blk, x, cfg, (cache["cross_k"][i], cache["cross_v"][i]),
                          positions=positions, kv=(cache["k"][i], cache["v"][i]),
                          cache_index=idx, cross_block=cross, mode=mode)
        x = pctx.constrain(x, "residual_dec")
    cache["idx"] = idx + 1
    x = layers.apply_norm(cfg.norm, params["dec_norm"], x)
    return unembed(cfg, params, x), cache
