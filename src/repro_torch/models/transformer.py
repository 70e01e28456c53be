"""LM-family model assembly: the dense, MoE, VLM, hybrid (Zamba2) and ssm
(RWKV6) families.

Blocks are a Python list of per-layer parameter dicts and the stacks are Python
loops over it. Under grad, ``remat`` names how each block is checkpointed for
the backward pass (``REMAT_POLICIES``, as in the reference). A moe block runs
``moe.moe_apply`` in place of the MLP and adds its load-balance loss to the
stack's aux; a vlm model is the dense stack behind an ``embeds`` prefix. A
hybrid model is ``hybrid_prologue`` Mamba2 layers (``params["prologue"]``), then
``hybrid_groups`` groups of ``hybrid_mamba_per_group`` Mamba2 layers
(``params["groups"]``, a list of lists), each group followed by the one shared
attention block (``params["shared_attn"]``, one weight set used after every
group). An ssm model is ``params["ln0"]`` (a LayerNorm on the embeddings) and
``num_layers`` RWKV6 layers (``rwkv.rwkv_block``), each layer's prefill starting
from a zero state. A family the port has no model of raises
``NotImplementedError`` naming it (the encdec family is ``models/encdec.py``).

Public API (used by train/, serve/ and launch/):
    init_lm(cfg, gen)                       -> params
    cast_params(cfg, params)                -> params with matmul weights cast once
    apply_lm(cfg, params, tokens, ...)      -> (hidden, aux, kvs|None)
    prefill_lm(cfg, params, tokens, ...)    -> (hidden, cache)
    decode_lm(cfg, params, cache, tokens)   -> (logits, cache)      1 new token
    init_cache(cfg, batch, max_seq, device=) -> cache dict
    unembed(cfg, params, hidden)            -> logits

The cache is ``{"k", "v": (L, B, S_max, Hkv, hd), "idx": int}``; a hybrid
model's is ``{"prologue": [state], "groups": [[state]], "attn_k", "attn_v":
(hybrid_groups, B, S_max, Hkv, hd), "idx": int}``, a state being a Mamba2 layer's
fp32 ``{"conv", "ssm"}``; an ssm model's is ``{"layers": [state], "idx": int}``,
a state being an RWKV6 layer's fp32 ``{"S", "x_att", "x_cmix"}``. ``idx`` is a
host int (reading a device scalar back every step would synchronise), and
``decode_lm`` updates the cache **in place**
(K/V rows written into the tensors, the layers' states replaced in the lists):
the cache it returns is the one it was given. ``write_slot`` copies a
one-sequence cache into one slot of a batched one.
"""
from __future__ import annotations

from functools import partial
from typing import Optional

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch import tree
from repro_torch.models import attention, layers, mamba, moe, rwkv
from repro_torch.obs.spans import serving_span
from repro_torch.parallel import ctx as pctx

PORTED_FAMILIES = ("dense", "moe", "vlm", "hybrid", "ssm")
# keys whose subtree cast_params keeps fp32: the norms (apply_norm multiplies in
# fp32; "norm" is a Mamba2 layer's and its inner norm's; "xattn_norm",
# "enc_norm" and "dec_norm" the encoder-decoder's; "ln0", "ln1" and "ln2" an
# RWKV6 model's), the MoE router (moe._route computes the routing in fp32 from
# it), the Mamba2 leaves that mamba_apply uses in fp32 (the convolution, the
# decay, the skip and dt's bias) and an RWKV6 layer's whole "block" (time_mix
# and channel_mix widen every weight to fp32 at use)
_FP32_KEYS = ("attn_norm", "mlp_norm", "final_norm", "router",
              "norm", "conv_w", "conv_b", "A_log", "D", "dt_bias",
              "xattn_norm", "enc_norm", "dec_norm", "block", "ln0", "ln1", "ln2")
# leading dims the JAX package stacks each of these subtrees on (its layers are
# scanned; the port keeps lists): compat unstacks and restacks them, and the
# optimizer's decay rule counts them as the reference's rank test sees them
JAX_STACKED_DIMS = {"blocks": 1, "prologue": 1, "groups": 2,
                    "enc_blocks": 1, "dec_blocks": 1}

# the counterparts of the reference's jax.checkpoint policies: which outputs of
# a block's forward are kept for the backward pass ("full" keeps none and runs
# the block again; "dots" keeps every matmul's output, "dots_no_batch" those
# of the matmuls without batch dims)
_MATMULS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
_BATCHED_MATMULS = (torch.ops.aten.bmm.default, torch.ops.aten.baddbmm.default)
REMAT_POLICIES = {
    "none": None,
    "full": (),
    "dots": _MATMULS + _BATCHED_MATMULS,
    "dots_no_batch": _MATMULS,
}


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
    p = {
        "attn_norm": layers.norm_init(cfg.norm, cfg.d_model, device=dev),
        "attn": attention.attn_init(gen, cfg),
        "mlp_norm": layers.norm_init(cfg.norm, cfg.d_model, device=dev),
    }
    if cfg.family == "moe":
        p["moe"] = moe.moe_init(gen, cfg)
    else:
        p["mlp"] = layers.mlp_init(gen, cfg.mlp, cfg.d_model, cfg.d_ff, bias=cfg.bias)
    return p


def _block_apply(p, x, cfg, *, positions, kv=None, cache_index=None,
                 attn_fn=None, mode=None, moe_impl="einsum"):
    with serving_span("model.attn"):
        h = layers.apply_norm(cfg.norm, p["attn_norm"], x)
        h, new_kv = attention.attn_apply(
            p["attn"], h, cfg, positions=positions, kv_cache=kv,
            cache_index=cache_index, attn_fn=attn_fn, mode=mode)
        x = x + h
    with serving_span("model.mlp"):
        h = layers.apply_norm(cfg.norm, p["mlp_norm"], x)
        if cfg.family == "moe":
            h, aux = moe.moe_apply(p["moe"], h, cfg, impl=moe_impl)
            return x + h, new_kv, aux
        # on purpose not as the reference, whose block runs the MLP at apply_mlp's
        # default type (bf16) whatever cfg.compute_dtype says: here it follows the
        # config. Every shipped config computes in bf16, where the two agree.
        h = layers.apply_mlp(cfg.mlp, p["mlp"], h,
                             dtype=layers.to_dtype(cfg.compute_dtype))
        return x + h, new_kv, 0.0


def _mamba_layer_init(gen, cfg):
    return {"norm": layers.norm_init(cfg.norm, cfg.d_model, device=gen.device),
            "mamba": mamba.mamba_init(gen, cfg)}


def _mamba_layer_apply(p, x, cfg, state=None):
    h = layers.apply_norm(cfg.norm, p["norm"], x)
    h, new_state = mamba.mamba_apply(p["mamba"], h, cfg, state=state)
    return x + h, new_state


def _rwkv_layer_init(gen, cfg):
    dev = gen.device
    return {"block": rwkv.rwkv_init(gen, cfg),
            "ln1": layers.norm_init("layernorm", cfg.d_model, device=dev),
            "ln2": layers.norm_init("layernorm", cfg.d_model, device=dev)}


def _rwkv_layer_apply(p, x, state, *, cfg):
    return rwkv.rwkv_block(p["block"], x, cfg, {"ln1": p["ln1"], "ln2": p["ln2"]},
                           state=state)


def _checkpointed(fn, remat):
    """``fn`` under the checkpointing that ``remat`` names; ``fn`` itself
    without grad (serving), where no backward pass will run."""
    if remat not in REMAT_POLICIES:
        raise ValueError(f"unknown remat policy {remat!r}; known: {sorted(REMAT_POLICIES)}")
    keep = REMAT_POLICIES[remat]
    if keep is None or not torch.is_grad_enabled():
        return fn
    if not keep:
        return lambda *a: checkpoint(fn, *a, use_reentrant=False)

    def policy(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op in keep
                else CheckpointPolicy.PREFER_RECOMPUTE)

    return lambda *a: checkpoint(
        fn, *a, use_reentrant=False,
        context_fn=partial(create_selective_checkpoint_contexts, policy))


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_lm(cfg, gen: torch.Generator, place=None):
    """Seeded parameters in fp32, on the generator's device.

    ``place(key, part)``, where given, is handed each part as it is drawn,
    in the draws' order (``"emb"``, ``"final_norm"``, ``"unembed"``, then
    each layer of ``"blocks"``; a hybrid's ``"prologue"`` layers, each
    group's layers as ``"groups"``, ``"shared_attn"``; an ssm's ``"blocks"``
    and ``"ln0"``) and its result kept in the part's place: a caller that
    shards and casts each part there never holds the whole fp32 tree, and
    the values are the unplaced build's."""
    _require_ported(cfg)
    keep = place or (lambda key, part: part)
    params = {"emb": keep("emb", layers.embed_init(gen, cfg.vocab_size, cfg.d_model)),
              "final_norm": keep("final_norm", layers.norm_init(cfg.norm, cfg.d_model,
                                                                device=gen.device))}
    if not cfg.tie_embeddings:
        params["unembed"] = keep("unembed", layers.dense_init(gen, cfg.d_model,
                                                              cfg.vocab_size))
    if cfg.family == "hybrid":
        params["prologue"] = [keep("prologue", _mamba_layer_init(gen, cfg))
                              for _ in range(cfg.hybrid_prologue)]
        params["groups"] = [[keep("groups", _mamba_layer_init(gen, cfg))
                             for _ in range(cfg.hybrid_mamba_per_group)]
                            for _ in range(cfg.hybrid_groups)]
        # ONE weight set, reused
        params["shared_attn"] = keep("shared_attn", _block_init(gen, cfg))
        return params
    if cfg.family == "ssm":
        params["blocks"] = [keep("blocks", _rwkv_layer_init(gen, cfg))
                            for _ in range(cfg.num_layers)]
        params["ln0"] = keep("ln0", layers.norm_init("layernorm", cfg.d_model,
                                                     device=gen.device))
        return params
    params["blocks"] = [keep("blocks", _block_init(gen, cfg)) for _ in range(cfg.num_layers)]
    return params


def cast_params(cfg, params, dtype=None, device=None):
    """Matmul weights, biases and the embedding table cast once to the compute type.

    ``layers.dense`` (and the MoE expert products) cast their weights on every
    call; eagerly that would re-cast every weight at every step. Cast once, the
    per-call cast is the identity and the numbers are the same. The subtrees
    under ``_FP32_KEYS`` stay fp32: the norms (``apply_norm`` multiplies in
    fp32), the MoE router (routing is computed in fp32 from it; rounded, it
    would choose other experts), the Mamba2 leaves ``mamba_apply`` and every
    leaf of an RWKV6 layer's ``block`` the RWKV6 mixes compute with in fp32
    (rounded, they would give other numbers with no error). With ``device``
    every leaf is also moved there.
    """
    dt = layers.to_dtype(dtype or cfg.compute_dtype)

    def walk(node, to):
        if isinstance(node, dict):
            return {k: walk(v, None if k in _FP32_KEYS else to)
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

def _kv_stack(cfg, layers_: int, batch: int, max_seq: int, dtype, device, kv_heads=None):
    """A zero ``(layers_, batch, max_seq, Hkv, hd)`` K/V stack; ``kv_heads``
    (``cfg.num_kv_heads`` by default) is the kv heads of a rank's block
    (``parallel.sharding.CacheBlock``)."""
    shape = (layers_, batch, max_seq, kv_heads or cfg.num_kv_heads, cfg.head_dim)
    return torch.zeros(shape, dtype=layers.to_dtype(dtype), device=device)


def init_cache(cfg, batch: int, max_seq: int, dtype=torch.bfloat16, *, device,
               kv_heads: Optional[int] = None):
    """An empty cache; ``kv_heads`` (``cfg.num_kv_heads`` by default) is the
    kv heads of a rank's block (``parallel.sharding.CacheBlock``)."""
    _require_ported(cfg)
    kv = partial(_kv_stack, cfg, batch=batch, max_seq=max_seq, dtype=dtype, device=device,
                 kv_heads=kv_heads)
    if cfg.family == "hybrid":
        # the Mamba2 states are fp32 whatever the compute type, as in the reference
        state = partial(mamba.mamba_state_init, cfg, batch, device=device)
        return {"prologue": [state() for _ in range(cfg.hybrid_prologue)],
                "groups": [[state() for _ in range(cfg.hybrid_mamba_per_group)]
                           for _ in range(cfg.hybrid_groups)],
                "attn_k": kv(cfg.hybrid_groups), "attn_v": kv(cfg.hybrid_groups),
                "idx": 0}
    if cfg.family == "ssm":
        # fp32 states whatever the compute type, as in the reference
        return {"layers": [rwkv.rwkv_state_init(cfg, batch, device=device)
                           for _ in range(cfg.num_layers)],
                "idx": 0}
    return {"k": kv(cfg.num_layers), "v": kv(cfg.num_layers), "idx": 0}


# the entries of a cache holding per-layer states (lists of dicts, one tensor a
# state leaf) and those holding K/V stacked over layers, by family
_STATE_PARTS = {"hybrid": ("prologue", "groups"), "ssm": ("layers",)}
_KV_PARTS = {"hybrid": ("attn_k", "attn_v"), "ssm": ()}


def write_slot(cfg, cache, slot: int, one):
    """Copies the tensors of ``one``, a cache of one sequence, into row ``slot``
    of the batched ``cache``, in place (the slot is the axis after the layer
    dims, where the reference's engine finds the slot count meeting 1). ``idx``
    is left to the caller."""
    parts = _STATE_PARTS.get(cfg.family, ())
    for big, small in zip(tree.leaves([cache[k] for k in parts]),
                          tree.leaves([one[k] for k in parts])):
        big[slot] = small[0]
    for key in _KV_PARTS.get(cfg.family, ("k", "v")):
        cache[key][:, slot] = one[key][:, 0]


# ---------------------------------------------------------------------------
# forward passes
# ---------------------------------------------------------------------------

def _embed_inputs(cfg, params, tokens, embeds, rows=False):
    """The token embeddings behind the precomputed prefix ``embeds`` (replicated
    over model) where given; with ``rows``, this model rank's rows of them
    (sequence parallelism)."""
    return layers.embed(params["emb"], tokens, dtype=layers.to_dtype(cfg.compute_dtype),
                        prefix=embeds, rows=rows)


def apply_lm(cfg, params, tokens, *, embeds=None, attn_fn=None,
             remat: str = "full", moe_impl: str = "einsum",
             collect_kv: bool = False, mode=None):
    """Training / prefill forward. Returns (hidden, aux, kv list|None); aux is
    the sum of the layers' MoE load-balance losses (0.0 for the other families).

    ``remat`` (a key of ``REMAT_POLICIES``) applies when grad mode is on: each
    block then runs under ``torch.utils.checkpoint``.

    Under sequence parallelism (``parallel.ctx.seq_parallel()``, which the
    sharded train step turns on under a train cell's residual spec) the
    residual is this model rank's rows of the sequence (the VLM prefix
    counted) from the embeddings on: the blocks' norms and residual adds,
    the hybrid's outer norms, RWKV6's ``ln0`` / ``ln1`` / ``ln2`` and the
    final norm run on the rows, ``positions`` stay whole, the token mixers
    (an attention, a Mamba2 layer, RWKV6's time and channel mixes) run on
    the gathered sequence and hand back the rank's rows, and the hidden
    state returned is the rows.
    """
    _require_ported(cfg)
    rows = pctx.seq_parallel()
    x = _embed_inputs(cfg, params, tokens, embeds, rows=rows)
    S = tokens.shape[1] + (0 if embeds is None else embeds.shape[1])
    positions = torch.arange(S, device=x.device)[None, :]
    aux = 0.0
    if cfg.family == "hybrid":
        x, kvs = _hybrid_stack(cfg, params, x, positions, attn_fn=attn_fn, remat=remat,
                               mode=mode)
        kvs = kvs if collect_kv else None
    elif cfg.family == "ssm":
        x = layers.apply_norm("layernorm", params["ln0"], x)
        st0 = rwkv.rwkv_state_init(cfg, x.shape[0], device=x.device)
        layer = _checkpointed(partial(_rwkv_layer_apply, cfg=cfg), remat)
        kvs = [] if collect_kv else None
        for blk in params["blocks"]:
            x, st = layer(blk, x, st0)
            x = pctx.constrain(x)
            if collect_kv:
                kvs.append(st)
    else:
        block = _checkpointed(partial(_block_apply, cfg=cfg, positions=positions,
                                      attn_fn=attn_fn, mode=mode, moe_impl=moe_impl),
                              remat)
        kvs = [] if collect_kv else None
        for blk in params["blocks"]:
            x, kv, a = block(blk, x)
            x = pctx.constrain(x)
            aux = aux + a
            if collect_kv:
                kvs.append(kv)
    x = layers.apply_norm(cfg.norm, params["final_norm"], x)
    return x, aux, kvs


def _hybrid_stack(cfg, params, x, positions, *, attn_fn, remat, mode):
    """The hybrid stack of ``apply_lm``: returns (x, (prologue states, [(group's
    states, shared block's (k, v))]))."""
    mlayer = partial(_mamba_layer_apply, cfg=cfg)
    # under grad the layers inside a group are always rematerialised in full
    # (unless remat is "none"), as in the reference
    inner = _checkpointed(mlayer, "full" if remat != "none" else "none")
    shared = params["shared_attn"]

    def group(blks, h):
        states = []
        for blk in blks:
            h, st = inner(blk, h)
            h = pctx.constrain(h)
            states.append(st)
        h, kv, _ = _block_apply(shared, h, cfg, positions=positions, attn_fn=attn_fn,
                                mode=mode)
        return pctx.constrain(h), states, kv

    layer, gbody = _checkpointed(mlayer, remat), _checkpointed(group, remat)
    pro_states, groups = [], []
    for blk in params["prologue"]:
        x, st = layer(blk, x)
        x = pctx.constrain(x)
        pro_states.append(st)
    for blks in params["groups"]:
        x, states, kv = gbody(blks, x)
        groups.append((states, kv))
    return x, (pro_states, groups)


def unembed(cfg, params, hidden):
    dt = layers.to_dtype(cfg.compute_dtype)
    if cfg.tie_embeddings:
        return hidden.to(dt) @ params["emb"]["table"].to(dt).T
    return layers.dense(params["unembed"], hidden, dtype=dt)


def prefill_lm(cfg, params, tokens, *, embeds=None, attn_fn=None,
               max_seq: Optional[int] = None, remat: str = "full",
               moe_impl: str = "einsum", mode=None):
    """Forward + build decode cache. Returns (hidden, cache).

    The per-layer states (Mamba2's, RWKV6's) are those the forward returns;
    only the K/V stacks are allocated here. Inside
    ``parallel.ctx.serving_cache`` the cache is this rank's block
    (``parallel.sharding.CacheBlock``): its batch rows (``tokens`` are
    those rows), the kv heads ``attn_apply`` collected (its own, or every
    kv head where they do not split over ``model``) and its block of the
    ``max_seq`` positions, of which it keeps the prompt's rows that fall
    there, and the states of the heads the rank computes. Under sequence
    parallelism (the sharded prefill's ``seq_split``) ``hidden`` is this
    model rank's rows, while the K/V each attention collects span the whole
    sequence (``attention.attn_apply`` projects them from the gathered
    one), so the cache is filled as without the split; so are the states,
    whose scans run on the gathered sequence (a Mamba2 conv state its last
    ``K - 1`` positions, an RWKV6 token-shift carry its last row, on every
    rank)."""
    hidden, _, kvs = apply_lm(cfg, params, tokens, embeds=embeds,
                              attn_fn=attn_fn, remat=remat, moe_impl=moe_impl,
                              collect_kv=True, mode=mode)
    # the prompt's positions (the prefix counted), not the hidden rows: under
    # sequence parallelism those are this model rank's block of them
    B, S = tokens.shape[0], tokens.shape[1] + (0 if embeds is None else embeds.shape[1])
    max_seq = max_seq or S
    block = pctx.cache_block()
    first, count, heads = 0, max_seq, None
    if block is not None:
        (first, count), heads = block.seq, block.heads[1]
    if cfg.family == "ssm":
        return hidden, {"layers": kvs, "idx": S}
    cache = {}
    ks, vs = _KV_PARTS.get(cfg.family, ("k", "v"))
    if cfg.family == "hybrid":
        pro_states, groups = kvs
        cache["prologue"] = pro_states
        cache["groups"] = [states for states, _ in groups]
        kvs = [kv for _, kv in groups]
    for key in (ks, vs):
        cache[key] = _kv_stack(cfg, len(kvs), B, count, cfg.compute_dtype, hidden.device,
                               kv_heads=heads)
    n = S if block is None else min(max(S - first, 0), count)   # the prompt's rows here
    for i, (k, v) in enumerate(kvs):
        cache[ks][i, :, :n] = k[:, first:first + n].to(cache[ks].dtype)
        cache[vs][i, :, :n] = v[:, first:first + n].to(cache[vs].dtype)
    cache["idx"] = S
    return hidden, cache


def decode_lm(cfg, params, cache, tokens, *, moe_impl: str = "einsum", mode=None):
    """One decode step. tokens: (B, 1). Returns (logits, cache), cache updated in place.

    A moe model routes the B new tokens as one group, at a capacity of
    ``max(1, int(B * k / E * capacity_factor))`` an expert: many choices of a
    small batch find their expert full and are dropped, as in the reference.
    """
    _require_ported(cfg)
    x = _embed_inputs(cfg, params, tokens, None)
    idx = int(cache["idx"])
    positions = torch.full((1, 1), idx, dtype=torch.int64, device=x.device)
    if cfg.family == "hybrid":
        states = cache["prologue"]
        for i, blk in enumerate(params["prologue"]):
            x, states[i] = _mamba_layer_apply(blk, x, cfg, state=states[i])
            x = pctx.constrain(x, "residual_dec")
        for g, blks in enumerate(params["groups"]):
            states = cache["groups"][g]
            for i, blk in enumerate(blks):
                x, states[i] = _mamba_layer_apply(blk, x, cfg, state=states[i])
                x = pctx.constrain(x, "residual_dec")
            x, _, _ = _block_apply(params["shared_attn"], x, cfg, positions=positions,
                                   kv=(cache["attn_k"][g], cache["attn_v"][g]),
                                   cache_index=idx, mode=mode)
            x = pctx.constrain(x, "residual_dec")
    elif cfg.family == "ssm":
        x = layers.apply_norm("layernorm", params["ln0"], x)
        states = cache["layers"]
        for i, blk in enumerate(params["blocks"]):
            x, states[i] = _rwkv_layer_apply(blk, x, states[i], cfg=cfg)
            x = pctx.constrain(x, "residual_dec")
    else:
        for i, blk in enumerate(params["blocks"]):
            x, _, _ = _block_apply(blk, x, cfg, positions=positions,
                                   kv=(cache["k"][i], cache["v"][i]),
                                   cache_index=idx, mode=mode, moe_impl=moe_impl)
            x = pctx.constrain(x, "residual_dec")
    cache["idx"] = idx + 1
    x = layers.apply_norm(cfg.norm, params["final_norm"], x)
    return unembed(cfg, params, x), cache
