"""Serve steps: prefill and single-token decode, greedy-sampled.

``make_serve_step`` returns the decode step the engine runs: one new token per
sequence against a resident KV cache.

With ``mesh=`` (the dense, vlm and moe families, ``sharding.SERVE_FAMILIES``)
both steps are partitioned over the mesh as the sharded train step is
(``train.trainer``), forward only. The parameters are ``DTensor``s; each
rank computes on its block of them in ``sharding.serve_specs``'s layout
(``init_params`` and ``shard_params`` place them so; a step raises on a
leaf placed otherwise), inside ``parallel.ctx.model_parallel`` with
``sharding.model_layout`` and the residual whole on every model rank. Each
rank serves its rows of the batch (``parallel.ctx.data_parallel`` over the
data axes; every rank the whole batch where the rows do not divide, or under
``seq_shard``) from its block of the KV cache, which is placed as
``sharding.cache_specs`` says (``sharding.CacheBlock``): its kv heads over
``model``, or, where they do not divide, its block of the sequence, whose
decode partials are merged over the ranks (``models.attention``). The batch
and the tokens may be ``DTensor``s (the dry-run's) or plain tensors of the
whole batch on every rank. A step returns this rank's rows of the next
tokens, and the cache as ``DTensor``s of the rank's blocks (``idx`` a host
int); the decode step updates the blocks in place. The greedy token over a
vocabulary split by ``model`` is ``parallel.ctx.vocab_argmax``'s.
"""
from __future__ import annotations

import contextlib
import weakref

import torch
from torch.distributed.tensor import DTensor

from repro_torch import tree
from repro_torch.models import api
from repro_torch.models.attention import knob_attention
from repro_torch.models.layers import to_dtype
from repro_torch.parallel import ctx as pctx
from repro_torch.parallel import sharding as shd


def greedy(logits):
    """The int32 greedy tokens of ``logits`` (..., V): ``torch.argmax``, over
    the ranks' blocks of a vocabulary split by ``model``
    (``parallel.ctx.vocab_argmax``)."""
    return pctx.vocab_argmax(logits).to(torch.int32)


# ---------------------------------------------------------------------------
# the serving layout's parameters
# ---------------------------------------------------------------------------

def _local_view(x, spec, mesh):
    """This rank's block of ``x`` (the whole tensor) under ``spec``: a view."""
    for dim, entry in enumerate(spec):
        if entry is not None:
            first, n = shd.entry_block(mesh, entry, x.shape[dim])
            x = x.narrow(dim, first, n)
    return x


def _placed(local, whole, spec, mesh):
    """``local`` (a block of ``whole``, or a copy of one) as a ``DTensor`` of
    ``spec``; a view into ``whole`` is copied first, so that the whole is
    not kept."""
    if local.numel() < whole.numel() and \
            local.untyped_storage().data_ptr() == whole.untyped_storage().data_ptr():
        local = local.clone()
    return DTensor.from_local(local, mesh, shd.placements(spec, mesh), shape=whole.shape,
                              stride=whole.stride())


def shard_params(cfg, params, mesh):
    """``params``, which every rank holds whole, as ``DTensor``s in the
    serving layout (``sharding.serve_specs``): each rank keeps its blocks."""
    specs = tree.leaves(shd.serve_specs(cfg, params, mesh), is_leaf=shd.is_spec)
    return tree.rebuild(params, [_placed(_local_view(x, s, mesh), x, s, mesh)
                                 for x, s in zip(tree.leaves(params), specs)])


def init_params(cfg, mesh, seed=0, *, device="cuda", dtype=None):
    """Seeded serving parameters on ``mesh`` in the serving layout, cast as
    ``api.cast_params`` casts them (``dtype``, by default the compute type):
    each part is drawn whole in fp32, and this rank's blocks of it cut and
    cast before the next part is drawn (``api.init``'s ``place``), so no rank
    holds the whole tree; the values are ``shard_params(cfg,
    api.cast_params(cfg, api.init(cfg, seed, device=device), dtype), mesh)``'s."""
    def place(key, part):
        whole = {key: [part] if key == "blocks" else part}
        leaves = tree.leaves(whole)
        specs = tree.leaves(shd.serve_specs(cfg, whole, mesh), is_leaf=shd.is_spec)
        views = tree.rebuild(whole, [_local_view(x, s, mesh) for x, s in zip(leaves, specs)])
        cast = tree.leaves(api.cast_params(cfg, views, dtype))
        placed = tree.rebuild(whole, [_placed(c, x, s, mesh)
                                      for c, x, s in zip(cast, leaves, specs)])[key]
        return placed[0] if isinstance(placed, list) else placed

    return api.init(cfg, seed, device=device, place=place)


class _Layout:
    """What a sharded step reads of ``mesh``: the serving placements of the
    parameters (once), the ``CacheBlock`` of a cache's global shape, and
    the scope the model runs in."""

    def __init__(self, cfg, mesh, seq_shard):
        if cfg.family not in shd.SERVE_FAMILIES:
            raise NotImplementedError(
                f"the {cfg.family} family ({cfg.name}) has no sharded serving step; "
                f"partitioned: {shd.SERVE_FAMILIES}")
        self.cfg, self.mesh, self.seq_shard = cfg, mesh, seq_shard
        self.layout = shd.model_layout(cfg, shd.axis_sizes(mesh)["model"])
        self.param_pl = None
        self.held = ([], None)      # weak references to the leaves, and their local tree

    def _drop_held(self, _ref=None):
        self.held = ([], None)

    def params(self, params):
        """The rank's blocks of ``params``: ``DTensor``s placed in the serving
        layout, or ``ValueError``. The blocks are the leaves' own local
        tensors; their tree is kept while the step is handed the same leaves
        (a decode step's host time: one ``to_local`` a leaf would cost more
        than a layer's kernels), and dropped with the leaves: the step holds
        them only weakly."""
        leaves = tree.leaves(params)
        held, local = self.held
        if len(held) == len(leaves) and all(r() is b for r, b in zip(held, leaves)):
            return local
        self._drop_held()
        if self.param_pl is None:
            specs = tree.leaves(shd.serve_specs(self.cfg, params, self.mesh),
                                is_leaf=shd.is_spec)
            self.param_pl = [shd.placements(s, self.mesh) for s in specs]
        for i, (p, pl) in enumerate(zip(leaves, self.param_pl)):
            if not isinstance(p, DTensor) or tuple(p.placements) != pl:
                raise ValueError(f"parameter leaf {i}: a sharded serving step takes "
                                 f"DTensors placed {pl} (sharding.serve_specs: "
                                 "serve.decode.init_params / shard_params), not "
                                 f"{type(p).__name__} {getattr(p, 'placements', '')}")
        local = tree.rebuild(params, [p.to_local() for p in leaves])
        self.held = ([weakref.ref(p, self._drop_held) for p in leaves], local)
        return local

    def block(self, batch: int, max_seq: int):
        return shd.cache_block(self.cfg, self.mesh, batch=batch, max_seq=max_seq,
                               seq_shard=self.seq_shard)

    def rows(self, x, block):
        """This rank's rows of the batch tensor ``x``."""
        if isinstance(x, DTensor):
            spec = (block.spec[1],) + (None,) * (x.dim() - 1)
            pl = shd.placements(spec, self.mesh)
            return (x if tuple(x.placements) == pl
                    else x.redistribute(self.mesh, pl)).to_local()
        first, n = block.rows
        return x.narrow(0, first, n)

    def scope(self, block):
        s = contextlib.ExitStack()
        s.enter_context(pctx.model_parallel(self.mesh, self.layout))
        s.enter_context(pctx.serving_cache(self.mesh, block))
        if block.rows_split:
            s.enter_context(pctx.data_parallel(self.mesh))
        return s

    def placed_cache(self, cache, block, batch: int, max_seq: int):
        """The rank's cache blocks as ``DTensor``s of the global cache of
        ``batch`` rows and ``max_seq`` positions."""
        pl = shd.placements(block.spec, self.mesh)
        out = {}
        for key in ("k", "v"):
            t = cache[key]
            shape = torch.Size((t.shape[0], batch, max_seq, self.cfg.num_kv_heads, t.shape[4]))
            out[key] = DTensor.from_local(t, self.mesh, pl, shape=shape,
                                          stride=_contiguous_stride(shape))
        out["idx"] = cache["idx"]
        return out

    def local_cache(self, cache, block):
        """The rank's blocks of ``cache`` (``DTensor``s placed as ``block``
        says), the tensors the step writes in place."""
        pl = shd.placements(block.spec, self.mesh)
        out = {}
        for key in ("k", "v"):
            t = cache[key]
            if not isinstance(t, DTensor) or tuple(t.placements) != pl:
                raise ValueError(f"cache[{key!r}]: a sharded decode step takes the "
                                 f"cache as DTensors placed {pl} (cache_specs), not "
                                 f"{type(t).__name__} {getattr(t, 'placements', '')}")
            out[key] = t.to_local()
        out["idx"] = cache["idx"]
        return out


def _contiguous_stride(shape):
    """The strides of a contiguous tensor of ``shape`` (none is made)."""
    stride, n = [], 1
    for size in reversed(shape):
        stride.append(n)
        n *= size
    return tuple(reversed(stride))


def make_prefill_step(cfg, *, max_seq: int, remat: str = "full",
                      attn_chunk: int = 512, cast_params: str = "none",
                      attn_pv_bf16: bool = False, mode=None, mesh=None,
                      seq_shard: bool = False):
    """The prefill step; over ``mesh`` when one is given (the module's
    docstring; ``seq_shard``: the cache's long-context layout, every rank
    serving the whole batch)."""
    lay = None if mesh is None else _Layout(cfg, mesh, seq_shard)

    def run(params, batch):
        if cast_params != "none":
            params = api.cast_params(cfg, params, cast_params)
        attn_fn = knob_attention(attn_chunk, attn_pv_bf16, device=batch["tokens"].device,
                                 dtype=to_dtype(cfg.compute_dtype), mode=mode)
        hidden, cache = api.prefill(cfg, params, batch, max_seq=max_seq,
                                    remat=remat, attn_fn=attn_fn, mode=mode)
        logits = api.unembed(cfg, params, hidden[:, -1:])
        return greedy(logits), cache

    @torch.no_grad()
    def prefill_step(params, batch):
        if lay is None:
            return run(params, batch)
        B = batch["tokens"].shape[0]          # a DTensor's shape is the global one
        block = lay.block(B, max_seq)
        local = {k: lay.rows(v, block) for k, v in batch.items()}
        with lay.scope(block):
            next_tok, cache = run(lay.params(params), local)
        return next_tok, lay.placed_cache(cache, block, B, max_seq)
    return prefill_step


def make_serve_step(cfg, *, mode=None, mesh=None, seq_shard: bool = False):
    """The decode step; over ``mesh`` when one is given (the module's
    docstring)."""
    lay = None if mesh is None else _Layout(cfg, mesh, seq_shard)

    def run(params, cache, tokens):
        logits, cache = api.decode(cfg, params, cache, tokens, mode=mode)
        return greedy(logits[:, -1:]), cache

    @torch.no_grad()
    def serve_step(params, cache, tokens):
        """tokens: (B, 1) -> (next_token (B,1), cache); the cache is updated in place."""
        if lay is None:
            return run(params, cache, tokens)
        block = lay.block(tokens.shape[0], cache["k"].shape[2])
        local = lay.local_cache(cache, block)
        with lay.scope(block):
            next_tok, local = run(lay.params(params), local, lay.rows(tokens, block))
        cache["idx"] = local["idx"]
        return next_tok, cache
    return serve_step
