"""Attention: GQA projections + FlashAttention-style chunked online softmax.

``flash_ref`` is the plain-PyTorch online-softmax implementation (algorithmically
FlashAttention, looped over KV chunks). ``attn_apply`` sends attention to the
hand-written kernels through ``kernels.ops``: prefill to ``mha_forward``,
cached decode to ``decode_forward``, and cross-attention (``cross_attend``) to
either, by the query's length.
"""
from __future__ import annotations

import math
from functools import partial

import torch

from repro_torch.kernels import ops
from repro_torch.models import layers
from repro_torch.parallel import ctx as pctx

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


def knob_attention(chunk: int, pv_bf16: bool, *, device, dtype, mode=None):
    """The self-attention that the ``attn_chunk`` / ``attn_pv_bf16`` knobs ask
    for, as an ``attn_fn``: None means ``ops.mha_forward`` (the kernel route).

    At the defaults (chunk 512, P kept fp32) that is always the kernel route.
    Otherwise, on a CPU tensor or under ``mode="reference"`` (the plain route
    either way), ``flash_ref`` with those arguments, as the reference maps the
    knobs. A meta tensor (the dry-run's count) takes what a CPU tensor takes:
    it computes nothing, so nothing falls back. On a CUDA tensor nothing falls
    back to the plain version: ``pv_bf16`` at chunk 512 with bf16 compute
    takes the kernel, which rounds P to bf16 so already, and any other
    setting raises (ROADMAP C15).
    """
    if chunk == 512 and not pv_bf16:
        return None
    if torch.device(device).type in ("cpu", "meta") or mode == "reference":
        return partial(flash_ref, chunk=chunk, pv_bf16=pv_bf16)
    if chunk == 512 and dtype == torch.bfloat16:
        return None
    raise NotImplementedError(
        f"attn_chunk={chunk}, attn_pv_bf16={pv_bf16} with {dtype} compute has no "
        "kernel on the card: the bf16 forward kernel takes pv_bf16 at chunk 512, the "
        "fp32 one keeps P fp32 (mode='reference' runs the plain flash_ref)")


def decode_attend(q, k_cache, v_cache, cache_len, *, q_offset=None):
    """Single-token decode over a (possibly longer-than-filled) KV cache.

    q: (B, 1, H, D); caches: (B, S_max, Hkv, D); cache_len: int, or (B,) tensor.
    Positions >= cache_len are masked.
    """
    B, L, H, D = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    G = H // Hkv
    qg = q.reshape(B, L, Hkv, G, D).float() * (1.0 / math.sqrt(D))
    s = pctx.constrain(torch.einsum("blhgd,bshd->blhgs", qg, k_cache.float()), "scores_dec")
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


def cross_attend(q, k, v, *, attn_fn=None, mode=None):
    """Non-causal attention of q (B, L, H, D) over precomputed k/v (B, S, Hkv, D).

    ``attn_fn`` where given, as in the reference. Otherwise the kernels, through
    ``kernels.ops``: a one-token query (a decode step) reads k/v as a filled
    cache of length S; a longer query takes the non-causal forward (L != S),
    and so does one token under autograd, since the decode kernel has no
    backward. A CUDA tensor takes the kernel or raises; a CPU tensor, or
    ``mode="reference"``, the kernel's plain version.
    """
    if attn_fn is not None:
        return attn_fn(q, k, v, causal=False)
    needs_grad = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    if q.shape[1] == 1 and not needs_grad:
        return ops.decode_forward(q, k, v, k.shape[1], mode=mode)
    return ops.mha_forward(q, k, v, causal=False, mode=mode)


def _kv_heads_of_q_heads(cfg, n_q: int, rank: int):
    """For model rank ``rank``'s ``n_q`` q heads (its block of the model's), the
    kv heads they map to (``h -> h // G``): ``(first, count, index)``, the
    contiguous run of kv heads to project, and ``index`` the kv head of each
    local q head within that run where the run's heads are not shared by
    equal groups of consecutive q heads (else ``None``: local ``G`` is the
    q heads over the run's kv heads)."""
    G = cfg.num_heads // cfg.num_kv_heads
    kv = [h // G for h in range(rank * n_q, (rank + 1) * n_q)]
    first, count = kv[0], kv[-1] - kv[0] + 1
    if n_q % count == 0 and all(kv[j] - first == j // (n_q // count) for j in range(n_q)):
        return first, count, None
    return first, count, [h - first for h in kv]


def _kv_slice(p, first: int, count: int, hd: int):
    """The columns of a gathered ``wk`` / ``wv`` leaf for kv heads
    ``first .. first + count``."""
    cols = slice(first * hd, (first + count) * hd)
    return {k: (w[:, cols] if k == "w" else w[cols]) for k, w in p.items()}


def _rank_heads(p, cfg):
    """``(split, H, kv)`` of this model rank: whether the layout of
    ``parallel.ctx.model_parallel`` splits the q heads, the q heads the rank
    computes, and ``kv = (wk, wv, Hkv, index)``: the leaves it projects its
    kv heads with (its ``wk`` / ``wv`` shard where the layout splits the kv
    heads too, else the columns of the whole leaves that its q heads need),
    how many, and ``_kv_heads_of_q_heads``'s ``index``."""
    H, Hkv = cfg.num_heads, cfg.num_kv_heads
    lay = pctx.layout()
    split = lay is not None and lay.heads
    wk, wv, index = p["wk"], p["wv"], None
    if split:
        H //= pctx.model_size()
        if lay.kv_heads:
            Hkv //= pctx.model_size()
        else:                                       # whole: this rank's kv heads
            first, Hkv, index = _kv_heads_of_q_heads(cfg, H, pctx.model_index())
            wk, wv = (_kv_slice(w, first, Hkv, cfg.head_dim) for w in (wk, wv))
    return split, H, (wk, wv, Hkv, index)


def _project_kv(kv, x, cfg, proj):
    """(k, v), each (B, S, heads, hd), of ``x`` through ``_rank_heads``'s ``kv``
    and ``proj`` (``layers.dense``, or ``dense_split`` of a ``split_input``)."""
    wk, wv, Hkv, index = kv
    B, S, _ = x.shape
    dt = layers.to_dtype(cfg.compute_dtype)
    k = proj(wk, x, dtype=dt).reshape(B, S, Hkv, cfg.head_dim)
    v = proj(wv, x, dtype=dt).reshape(B, S, Hkv, cfg.head_dim)
    if index is not None:                           # one kv head a q head
        idx = torch.tensor(index, device=k.device)
        k, v = k[:, :, idx], v[:, :, idx]
    return k, v


def project_cross_kv(p, enc_h, cfg):
    """The cross-attention's (k, v) of the encoder output ``enc_h`` (B, S_enc,
    d) through ``p``'s ``wk`` / ``wv``: the kv heads this model rank's q heads
    need where the layout splits the heads (``_rank_heads``); the gradient of
    ``enc_h`` is then the ranks' fp32 partials summed over ``model`` and
    rounded once."""
    split, _, kv = _rank_heads(p, cfg)
    if split:
        return _project_kv(kv, layers.whole_input(enc_h), cfg, layers.dense_split)
    return _project_kv(kv, enc_h, cfg, layers.dense)


def _heads_of_rank(cfg, n_q: int, k, v):
    """Of ``k`` / ``v`` (B, S, Hkv, D) holding every kv head, those of this
    model rank's ``n_q`` q heads (``_kv_heads_of_q_heads``)."""
    first, count, index = _kv_heads_of_q_heads(cfg, n_q, pctx.model_index())
    k, v = k[:, :, first:first + count], v[:, :, first:first + count]
    if index is not None:
        idx = torch.tensor(index, device=k.device)
        k, v = k[:, :, idx], v[:, :, idx]
    return k, v


def _merged(acc, m, l, axes):
    """The fp32 ``(acc, m, l)`` partials of this rank's block of a cache split
    by sequence over ``axes``, gathered from every block
    (``parallel.ctx.cache_seq_gather``) and merged (``merge_partial_attn``):
    (B, H, D)."""
    D = acc.shape[-1]
    parts = pctx.cache_seq_gather(torch.cat([acc, m[..., None], l[..., None]], dim=-1), axes)
    return merge_partial_attn(parts[..., :D], parts[..., D], parts[..., D + 1])


def _cross_blocks(q, k, v, block, mode):
    """A decode step's cross-attention (q (B, 1, H, D)) over this rank's
    ``block`` of a cross cache split by sequence (every row filled): the
    kernel's partials over the block, merged over ``block.seq_axes``."""
    B, _, H, D = q.shape
    acc, m, l = ops.decode_forward(q, k, v, k.shape[1], mode=mode, return_partials=True)
    return _merged(acc, m, l, block.seq_axes).to(q.dtype).reshape(B, 1, H, D)


def _decode_blocks(p, q, k, v, kv_cache, idx: int, block, cfg, *, split, every_kv, mode):
    """A decode step over this rank's ``block`` of a serving cache
    (``parallel.ctx.serving_cache``) whose sequence is split over
    ``block.seq_axes``, or which holds every kv head while the rank's q heads
    are a block of them (``every_kv``): the ``wo`` product of the attention
    output, (B, 1, d).

    The rank whose block holds position ``idx`` writes the new token's K/V
    there, in place. ``every_kv``: q is gathered over ``model`` first, so that
    the rank's partials hold every q head. The kernel's fp32 ``(acc, m, l)``
    partials over the block's filled rows (``clamp(idx + 1 - first, 0,
    count)``) are gathered over the axes that split the sequence and merged
    by ``merge_partial_attn`` (the maximum ``m``, ``acc`` and ``l`` rescaled,
    normalised once). A block with no filled row launches nothing: it gives
    ``(0, -inf, 0)``, which the merge weighs by ``exp(-inf) = 0`` against
    the finite maximum of the block holding position 0. With every head's
    output on every rank, ``wo`` computes the rank's output columns without
    gathering its input again (``layers.dense_joined_whole``)."""
    k_cache, v_cache = kv_cache
    first, count = block.seq
    if first <= idx < first + count:
        k_cache[:, idx - first] = k[:, 0].to(k_cache.dtype)
        v_cache[:, idx - first] = v[:, 0].to(v_cache.dtype)
    if every_kv:
        q = pctx.all_gather(q, 2, pctx.model_group())
    B, _, H, D = q.shape
    clen = min(max(idx + 1 - first, 0), count)
    if clen:
        acc, m, l = ops.decode_forward(q, k_cache, v_cache, clen, mode=mode,
                                       return_partials=True)
    else:
        f32 = dict(dtype=torch.float32, device=q.device)
        acc, m, l = (torch.zeros((B, H, D), **f32), torch.full((B, H), -math.inf, **f32),
                     torch.zeros((B, H), **f32))
    o = _merged(acc, m, l, block.seq_axes).to(q.dtype).reshape(B, 1, H * D)
    dt = layers.to_dtype(cfg.compute_dtype)
    if every_kv:
        return layers.dense_joined_whole(p["wo"], o, dtype=dt)
    return (layers.dense_joined if split else layers.dense)(p["wo"], o, dtype=dt)


def attn_apply(p, x, cfg, *, positions, kv_cache=None, cache_index=None,
               cross_kv=None, cross_block=None, attn_fn=None, use_rope=True, causal=None,
               mode=None):
    """Returns (out, new_kv) where new_kv is (k, v) of this call's tokens.

    kv_cache: optional (k_cache, v_cache) of shape (B, S_max, Hkv, D) -- decode
    path (x is (B,1,d)). The new token's K and V are written into these tensors
    **in place** at ``cache_index`` (a host int), and the same tensors are
    returned. cross_kv: precomputed (k, v) for cross-attention (no cache write;
    ``cross_attend``). ``causal`` (default ``cfg.causal``) masks the
    self-attention; ``attn_fn`` is called with it too. ``mode`` is handed to
    ``kernels.ops``.

    Inside ``parallel.ctx.model_parallel``, where the layout splits the q
    heads, ``wq`` holds this model rank's block of them
    (``parallel.sharding.compute_layout``): the rank projects
    (``layers.dense_split``) and runs the kernel on those heads and the kv
    heads they map to, either its ``wk`` / ``wv`` shard (the layout splits
    the kv heads too) or the columns of the whole leaves that it needs, and
    ``wo`` is ``layers.dense_joined`` over the ranks' heads (``_rank_heads``;
    a given ``cross_kv`` holds the kv heads of the rank's q heads,
    ``project_cross_kv``). The kernel's ``h -> h // G`` map on the local
    heads is the model's on the global ones.

    Under sequence parallelism (``parallel.ctx.seq_parallel()``) ``x`` is
    this model rank's rows and so is the output: q, k and v come from the
    gathered sequence (``layers.split_input``), rope runs on the whole
    ``positions``, the kernel on the rank's heads over the whole sequence,
    and ``wo`` hands back the rank's rows (``layers.dense_joined``). Where
    the q heads do not split, the whole attention runs alike on every rank on
    the gathered sequence (``parallel.ctx.seq_gather``), and each rank keeps
    its rows of the output, the cross-attention's too. A given ``cross_kv``
    is the whole encoder sequence's.

    Inside ``parallel.ctx.serving_cache`` (the sharded serving steps) the
    cache is this rank's ``sharding.CacheBlock``: its kv heads, or where they
    do not split over ``model`` every kv head (the rank then projects them
    all with the whole ``wk`` / ``wv``, attends with those of its q heads and
    returns them all for the cache), and its block of the sequence. A decode
    step over a cache split by sequence, or holding every kv head while the
    q heads split, takes ``_decode_blocks``. ``cross_block``: a decode
    step's ``cross_kv`` is that ``CacheBlock`` of a cross cache (an
    encoder-decoder's ``block.cross``); where it splits by sequence its
    partials are merged over the ranks (``_cross_blocks``).
    """
    hd = cfg.head_dim
    split, H, kv = _rank_heads(p, cfg)
    block = pctx.cache_block()
    # a serving cache that holds every kv head on this rank while its q heads
    # are a block of the model's (the kv heads do not split): the rank
    # projects every kv head, with the whole wk / wv
    every_kv = block is not None and split and not pctx.layout().kv_heads
    rows = pctx.seq_parallel() and not split
    if rows:
        x = pctx.seq_gather(x)
    dt = layers.to_dtype(cfg.compute_dtype)
    causal = cfg.causal if causal is None else causal
    proj, out_proj = layers.dense, layers.dense
    if split:
        proj, out_proj = layers.dense_split, layers.dense_joined
        x = layers.split_input(x)
    B, L, _ = x.shape
    q = proj(p["wq"], x, dtype=dt).reshape(B, L, H, hd)
    if cross_kv is not None:
        k, v = cross_kv
        if use_rope:
            q = layers.rope(q, positions, cfg.rope_theta)
        if cross_block is not None and cross_block.seq_axes:
            o = _cross_blocks(q, k, v, cross_block, mode)
        else:
            o = cross_attend(q, k, v, attn_fn=attn_fn, mode=mode)
        out = out_proj(p["wo"], o.reshape(B, L, H * hd), dtype=dt)
        return (pctx.seq_rows(out) if rows else out), None

    if every_kv:
        kv = (p["wk"], p["wv"], cfg.num_kv_heads, None)
    k, v = _project_kv(kv, x, cfg, proj)
    if use_rope:
        q = layers.rope(q, positions, cfg.rope_theta)
        k = layers.rope(k, positions, cfg.rope_theta)

    if kv_cache is not None and block is not None and (block.seq_axes or every_kv):
        out = _decode_blocks(p, q, k, v, kv_cache, int(cache_index), block, cfg,
                             split=split, every_kv=every_kv, mode=mode)
        return out, kv_cache
    if kv_cache is not None:
        k_cache, v_cache = kv_cache
        idx = int(cache_index)
        k_cache[:, idx:idx + L] = k.to(k_cache.dtype)
        v_cache[:, idx:idx + L] = v.to(v_cache.dtype)
        o = ops.decode_forward(q, k_cache, v_cache, idx + L, mode=mode)
        return out_proj(p["wo"], o.reshape(B, L, H * hd), dtype=dt), (k_cache, v_cache)

    ka, va = _heads_of_rank(cfg, H, k, v) if every_kv else (k, v)
    if attn_fn is not None:
        o = attn_fn(q, ka, va, causal=causal)
    else:
        o = ops.mha_forward(q, ka, va, causal=causal, mode=mode)
    out = out_proj(p["wo"], o.reshape(B, L, H * hd), dtype=dt)
    if rows:
        out = pctx.seq_rows(out)
    return out, (pctx.constrain(k, "kv_collect"), pctx.constrain(v, "kv_collect"))
