"""Serve steps: prefill and single-token decode, greedy-sampled.

``make_serve_step`` returns the decode step the engine runs: one new token per
sequence against a resident KV cache.

With ``mesh=`` (every family) both steps are partitioned over the mesh as the
sharded train step is (``train.trainer``), forward only. The parameters are
``DTensor``s; each rank computes on its block of them in
``sharding.serve_specs``'s layout (``init_params`` and ``shard_params`` place
them so, a Mamba2 layer's fused leaves rank-major; a step raises on a leaf
placed otherwise), inside ``parallel.ctx.model_parallel`` with
``sharding.model_layout``. The decode step keeps the residual whole on every
model rank. The prefill splits it by sequence over ``model`` where
``parallel.ctx.seq_split`` says so (an enclosing residual spec that names
``model`` on the sequence dim, tp dividing the prompt's positions; an
encoder-decoder's encoder by its own frames: ROADMAP C38, C38b), as the
train step does, in every family; its greedy token is then read from the
last model rank's last row (``parallel.ctx.seq_last``). The token mixers
run on the gathered sequence, so the K/V stacks, the cross cache and the
per-layer states a split prefill returns are the whole sequence's, as
without the split (a Mamba2 conv state's last rows, an RWKV6 token-shift
carry the whole sequence's last row). Each
rank serves its rows of the batch (``parallel.ctx.data_parallel`` over the
data axes; every rank the whole batch where the rows do not divide, or under
``seq_shard``) from its block of every cache leaf, placed as
``sharding.serve_cache_specs`` says: a K/V stack's kv heads over ``model``,
or, where they do not divide, its block of the sequence, whose decode
partials are merged over the ranks (``models.attention``;
``sharding.CacheBlock``, an encoder-decoder's cross cache its ``cross``
block), and each per-layer state (Mamba2's, RWKV6's) by heads. The batch and
the tokens may be ``DTensor``s (the dry-run's) or plain tensors of the whole
batch on every rank. A step returns this rank's rows of the next tokens, and
the cache as ``DTensor``s of the rank's blocks (``idx`` a host int); the
decode step writes the K/V blocks in place and puts the new states in the
cache's lists, as the unsharded step does. The greedy token over a
vocabulary split by ``model`` is ``parallel.ctx.vocab_argmax``'s.
"""
from __future__ import annotations

import contextlib
import math
import weakref

import torch
from torch.distributed.tensor import DTensor

from repro_torch import tree
from repro_torch.models import api
from repro_torch.models.attention import knob_attention
from repro_torch.models.layers import to_dtype
from repro_torch.obs.spans import span
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
    serving layout (``sharding.serve_specs``; ``sharding.rank_major``): each
    rank keeps its blocks."""
    params = shd.rank_major(cfg, params, mesh)
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
        whole = shd.rank_major(cfg, {key: part}, mesh)
        leaves = tree.leaves(whole)
        specs = tree.leaves(shd.serve_specs(cfg, whole, mesh), is_leaf=shd.is_spec)
        views = tree.rebuild(whole, [_local_view(x, s, mesh) for x, s in zip(leaves, specs)])
        cast = tree.leaves(api.cast_params(cfg, views, dtype))
        return tree.rebuild(whole, [_placed(c, x, s, mesh)
                                    for c, x, s in zip(cast, leaves, specs)])[key]

    return api.init(cfg, seed, device=device, place=place)


def _cache_lengths(cache):
    """(positions of a cache's K/V stack, 1 for a family without one; its
    encoder positions, ``None`` for a family without a cross cache)."""
    kv = next((cache[k] for k in ("k", "attn_k") if k in cache), None)
    cross = cache.get("cross_k")
    return (1 if kv is None else kv.shape[2]), (None if cross is None else cross.shape[2])


class _Layout:
    """What a sharded step reads of ``mesh``: the serving placements of the
    parameters (once), the ``CacheBlock`` and the placements of a cache's
    global shape, and the scope the model runs in."""

    def __init__(self, cfg, mesh, seq_shard):
        self.cfg, self.mesh, self.seq_shard = cfg, mesh, seq_shard
        self.layout = shd.model_layout(cfg, shd.axis_sizes(mesh)["model"])
        self.param_pl = None
        self.held = ([], None)      # weak references to the leaves, and their local tree
        self.cache_pl = {}          # (batch, max_seq, s_enc) -> [(placements, spec)]

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

    def block(self, batch: int, max_seq: int, s_enc=None):
        return shd.cache_block(self.cfg, self.mesh, batch=batch, max_seq=max_seq,
                               seq_shard=self.seq_shard, s_enc=s_enc)

    def cache_placements(self, batch: int, max_seq: int, s_enc=None):
        """[(placements, spec)] of a cache's tensors in leaf order
        (``sharding.serve_cache_specs``), ``idx`` left out."""
        key = (batch, max_seq, s_enc)
        if key not in self.cache_pl:
            self.cache_pl[key] = [
                (shd.placements(spec, self.mesh), spec)
                for spec in shd.serve_cache_specs(self.cfg, self.mesh, batch=batch,
                                                  max_seq=max_seq, s_enc=s_enc,
                                                  seq_shard=self.seq_shard)]
        return self.cache_pl[key]

    def rows(self, x, block):
        """This rank's rows of the batch tensor ``x``."""
        if isinstance(x, DTensor):
            spec = (block.spec[1],) + (None,) * (x.dim() - 1)
            pl = shd.placements(spec, self.mesh)
            return (x if tuple(x.placements) == pl
                    else x.redistribute(self.mesh, pl)).to_local()
        first, n = block.rows
        return x.narrow(0, first, n)

    def scope(self, block, seq=False, stacks=None):
        """The model's scope over ``block``; ``seq`` / ``stacks``: the
        residual split by sequence (``parallel.ctx.model_parallel``)."""
        s = contextlib.ExitStack()
        s.enter_context(pctx.model_parallel(self.mesh, self.layout, seq=seq, stacks=stacks))
        s.enter_context(pctx.serving_cache(self.mesh, block))
        if block.rows_split:
            s.enter_context(pctx.data_parallel(self.mesh))
        return s

    def placed_cache(self, cache, placements):
        """``cache``'s tensors (the rank's blocks) as ``DTensor``s placed as
        ``placements`` says."""
        parts = {k: v for k, v in cache.items() if k != "idx"}
        out = tree.rebuild(parts, [_global(t, pl, spec, self.mesh) for t, (pl, spec)
                                   in zip(tree.leaves(parts), placements)])
        out["idx"] = cache["idx"]
        return out

    def local_cache(self, cache, placements):
        """The rank's blocks of ``cache`` (``DTensor``s placed as ``placements``
        says), the tensors the step reads and writes, in a cache of its own;
        ``ValueError`` on a tensor placed otherwise."""
        parts = {k: v for k, v in cache.items() if k != "idx"}
        local = []
        for (path, t), (pl, _) in zip(tree.leaves_with_paths(parts), placements):
            if not isinstance(t, DTensor) or tuple(t.placements) != pl:
                raise ValueError(f"cache{list(path)}: a sharded decode step takes the "
                                 f"cache as DTensors placed {pl} (serve_cache_specs), not "
                                 f"{type(t).__name__} {getattr(t, 'placements', '')}")
            local.append(t.to_local())
        out = tree.rebuild(parts, local)
        out["idx"] = cache["idx"]
        return out

    def write_back(self, cache, local, before, placements):
        """Puts into ``cache`` (``DTensor``s, in place) each tensor of
        ``local`` (its blocks after a decode step) that is not the block
        ``before`` held (the step's input, in leaf order): the per-layer
        states the step made anew; the K/V blocks were written in place."""
        parts = {k: v for k, v in cache.items() if k != "idx"}
        for (path, _), old, new, (pl, spec) in zip(
                tree.leaves_with_paths(parts), before,
                tree.leaves({k: v for k, v in local.items() if k != "idx"}), placements):
            if new is not old:
                node = cache
                for p in path[:-1]:
                    node = node[p]
                node[path[-1]] = _global(new, pl, spec, self.mesh)
        cache["idx"] = local["idx"]


def _global(t, pl, spec, mesh):
    """``t``, this rank's block, as a ``DTensor`` placed ``pl`` (``spec``):
    its global shape is the block's, each dim ``spec`` splits times the
    blocks there (equal blocks: ``sharding.sanitize_spec`` keeps an axis only
    where it divides the dim)."""
    sizes = shd.axis_sizes(mesh)
    shape = torch.Size(n * math.prod(sizes[a] for a in shd.entry_axes(e))
                       for n, e in zip(t.shape, spec))
    return DTensor.from_local(t, mesh, pl, shape=shape, stride=_contiguous_stride(shape))


def _contiguous_stride(shape):
    """The strides of a contiguous tensor of ``shape`` (none is made)."""
    stride, n = [], 1
    for size in reversed(shape):
        stride.append(n)
        n *= size
    return tuple(reversed(stride))


def seq_split(cfg, mesh, batch):
    """The sharded prefill's ``(seq, stacks)`` over ``mesh`` for ``batch``:
    ``parallel.ctx.seq_split``, the train step's rule, for every family
    (ROADMAP C38, C38b). ``cfg`` is not read: the family does not decide."""
    return pctx.seq_split(mesh, batch)


def make_prefill_step(cfg, *, max_seq: int, remat: str = "full",
                      attn_chunk: int = 512, cast_params: str = "none",
                      attn_pv_bf16: bool = False, mode=None, mesh=None,
                      seq_shard: bool = False):
    """The prefill step; over ``mesh`` when one is given (the module's
    docstring; ``seq_shard``: the cache's long-context layout, every rank
    serving the whole batch), its residual split by sequence where
    ``parallel.ctx.seq_split`` says so."""
    lay = None if mesh is None else _Layout(cfg, mesh, seq_shard)

    def run(params, batch):
        if cast_params != "none":
            params = api.cast_params(cfg, params, cast_params)
        attn_fn = knob_attention(attn_chunk, attn_pv_bf16, device=batch["tokens"].device,
                                 dtype=to_dtype(cfg.compute_dtype), mode=mode)
        hidden, cache = api.prefill(cfg, params, batch, max_seq=max_seq,
                                    remat=remat, attn_fn=attn_fn, mode=mode)
        logits = api.unembed(cfg, params, pctx.seq_last(hidden))
        return greedy(logits), cache

    @torch.no_grad()
    def prefill_step(params, batch):
        if lay is None:
            return run(params, batch)
        B = batch["tokens"].shape[0]          # a DTensor's shape is the global one
        s_enc = batch["frames"].shape[1] if "frames" in batch else None
        block = lay.block(B, max_seq, s_enc)
        local = {k: lay.rows(v, block) for k, v in batch.items()}
        seq, stacks = seq_split(cfg, mesh, local)
        with lay.scope(block, seq, stacks):
            next_tok, cache = run(lay.params(params), local)
        return next_tok, lay.placed_cache(cache, lay.cache_placements(B, max_seq, s_enc))
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
        with span("serve.decode"):
            if lay is None:
                return run(params, cache, tokens)
            B, (max_seq, s_enc) = tokens.shape[0], _cache_lengths(cache)
            block = lay.block(B, max_seq, s_enc)
            placements = lay.cache_placements(B, max_seq, s_enc)
            local = lay.local_cache(cache, placements)
            before = tree.leaves({k: v for k, v in local.items() if k != "idx"})
            with lay.scope(block):
                next_tok, local = run(lay.params(params), local, lay.rows(tokens, block))
            lay.write_back(cache, local, before, placements)
            return next_tok, cache
    return serve_step
