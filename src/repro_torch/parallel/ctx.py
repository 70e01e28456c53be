"""Activation-sharding context: model code calls ``constrain(x, kind)`` at
block boundaries (the reference's points). Inside an
``activation_sharding(...)`` scope a ``DTensor`` is redistributed to the
placements of its kind's spec on its own mesh; a plain tensor comes back
unchanged, since it already is a rank's own rows (the trainer hands the model
each rank's batch rows as plain tensors, which is what the residual's
``("data", None, None)`` means). Outside a scope, or for a kind the scope does
not name, ``constrain`` returns ``x`` unchanged.

A spec is the reference's ``PartitionSpec`` written as a plain tuple: one
entry a tensor dim, each ``None``, an axis name or a tuple of axis names.

``data_parallel(mesh)`` is the second scope the model reads. Each rank then
computes over its own rows of the batch, and ``data_sum`` adds a statistic
over the mesh's data axes, so that a quantity the reference computes over the
global batch (the loss's token count, the MoE load-balance statistics) is
global here too. Outside it ``data_sum`` is the identity and ``data_size`` 1.

``model_parallel(mesh, layout)`` is the third. Each rank then holds its
share of the leaves that ``layout`` (``sharding.model_layout``, read back with
``layout()``) splits over ``model`` and computes the layers' products on it,
each product column-parallel (``models.layers``'s ``dense_split`` and
``dense_joined``). The operators here are what those products and the
vocabulary-parallel lookup and loss are built from: ``model_group`` (``None``
outside the scope or with one model rank, where ``layout()`` is ``None`` too
and everything here is the identity and launches nothing),
``model_size``, ``all_reduce_f32``, ``all_gather``, ``to_model`` (identity
forward, the gradient summed over the ranks), ``from_model`` (the ranks' terms summed
forward, the gradient passed through), ``gather_from_model`` (the ranks'
blocks joined, the gradient of this rank's block passed back), ``model_max``
and ``model_index``.

``model_parallel(mesh, layout, seq=True)`` also splits the residual by
sequence (sequence parallelism, the reference's ``P(dp, "model", None)``
residual), in every family: between blocks each model rank holds the rows
``[r*S/tp, (r+1)*S/tp)`` of its data rows (``seq_parallel()``). A stack with
a sequence of its own (an encoder's frames) runs inside ``stack(name)``,
and ``model_parallel(..., stacks={name: split})`` gives it its own answer.
The operators the layers need for it work on the sequence dim (1) of a
``(B, S, ...)`` tensor and, like the others, are the identity and launch
nothing where ``seq_parallel()`` is false (outside the scope, or at one model
rank): ``seq_rows`` (this rank's rows of a whole tensor; the rows' gradients
all-gathered), ``seq_gather_f32`` (the ranks' rows gathered into the whole
sequence in fp32; the gradient's fp32 partials reduce-scattered back to the
rows and rounded once), ``seq_columns_to_rows`` (this rank's output columns
of the whole sequence turned into the whole columns of its rows, an
all-to-all; its backward the inverse all-to-all) and ``seq_rows_of_sum`` (the
ranks' terms summed and this rank's rows kept, a reduce-scatter, for terms of
which one rank's is not zero; the rows' gradients all-gathered). A sequence
gathered alike on every rank, whose gradient every rank then computes whole,
is ``seq_gather`` (a token mixer's input: Mamba2's, RWKV6's, a whole
attention's); ``join_columns`` joins the ranks' output columns, or under the
split turns them into this rank's rows; ``seq_last`` brings the whole
sequence's last row to every model rank (a prefill's greedy token). None of
them sums per-rank partial products in the forward (ROADMAP C32): each moves
values, sums fp32 partials of an input's gradient, or (``seq_rows_of_sum``)
adds zeros to a value. Whether a step splits is ``seq_split``'s answer, the
one rule of the train step and the serving steps (``residual_split``: the
activation scope's residual spec names ``model`` on the sequence dim and tp
divides the positions).

``serving_cache(mesh, block)`` is the serving steps' scope
(``serve.decode``): the KV cache the model reads and writes is this rank's
``sharding.CacheBlock``. What serving needs beside the operators above, none
with a gradient: ``cache_seq_gather`` (a decode step's partials of every
block of a cache split by sequence, for their merge), ``vocab_argmax`` (the
greedy token over a vocabulary split by ``model``, ROADMAP C41) and
``data_gather`` / ``data_rows`` (an MoE decode group spanning the data
ranks, C40).
"""
from __future__ import annotations

import threading
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.parallel import sharding as shd

_STATE = threading.local()


@dataclass(frozen=True)
class ActivationSpecs:
    specs: Dict[str, Tuple] = field(default_factory=dict)

    def get(self, kind: str) -> Optional[Tuple]:
        return self.specs.get(kind)


def current() -> Optional[ActivationSpecs]:
    return getattr(_STATE, "specs", None)


@contextmanager
def activation_sharding(**kinds):
    """activation_sharding(residual=("data", "model", None), ...)"""
    prev = current()
    _STATE.specs = ActivationSpecs(dict(kinds))
    try:
        yield
    finally:
        _STATE.specs = prev


def constrain(x, kind: str = "residual"):
    ctx = current()
    if ctx is None:
        return x
    spec = ctx.get(kind)
    if spec is None or not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    return x.redistribute(mesh, shd.placements(spec, mesh))


# ---------------------------------------------------------------------------
# data-parallel statistics
# ---------------------------------------------------------------------------

# process-wide, not thread-local: the autograd engine runs a CUDA backward, and
# the checkpointed forwards it re-runs, on a thread of its own
_DATA_MESH = None


def data_mesh():
    """The mesh of the enclosing ``data_parallel`` scope, or ``None``."""
    return _DATA_MESH


@contextmanager
def data_parallel(mesh):
    """Within the scope each rank computes over its own batch rows, and
    ``data_sum`` adds over ``mesh``'s data axes (``sharding.fsdp_axes``)."""
    global _DATA_MESH
    prev, _DATA_MESH = _DATA_MESH, mesh
    try:
        yield
    finally:
        _DATA_MESH = prev


def data_size() -> int:
    """How many ranks' rows make the global batch: 1 outside a scope."""
    mesh = data_mesh()
    return 1 if mesh is None else shd.fsdp_size(mesh)


def data_index(mesh) -> int:
    """This rank's position among the data ranks of ``mesh`` (its rows' block
    of the global batch)."""
    sizes = shd.axis_sizes(mesh)
    i = 0
    for a in shd.fsdp_axes(mesh):
        i = i * sizes[a] + mesh.get_local_rank(a)
    return i


def data_sum(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """``x`` summed over the data ranks of ``mesh`` (by default the enclosing
    scope's), as a new tensor without gradient; ``x`` itself without a mesh or
    with one data rank. Every rank of the mesh must call it, in the same order."""
    mesh = mesh if mesh is not None else data_mesh()
    if mesh is None:
        return x
    sizes = shd.axis_sizes(mesh)
    axes = [a for a in shd.fsdp_axes(mesh) if sizes[a] > 1]
    if not axes:
        return x
    out = x.detach().clone()
    for a in axes:
        dist.all_reduce(out, group=mesh.get_group(a))
    return out


# ---------------------------------------------------------------------------
# tensor parallelism over ``model``
# ---------------------------------------------------------------------------

# process-wide for the same reason as _DATA_MESH: (mesh, layout, seq, stacks),
# and the stack the model is running (``stack``)
_MODEL = (None, None, False, {})
_STACK = None


@contextmanager
def model_parallel(mesh, layout, seq: bool = False, stacks: Optional[Mapping[str, bool]] = None):
    """Within the scope the model's products are partitioned over ``mesh``'s
    ``model`` axis as ``layout`` (a ``sharding.ModelLayout``) says, each rank
    computing on its shards of the leaves; with ``seq`` the residual is also
    split by sequence over ``model`` (``seq_parallel``). ``stacks`` maps a
    stack with a sequence of its own (``stack``) to its own answer."""
    global _MODEL
    prev, _MODEL = _MODEL, (mesh, layout, seq, dict(stacks or {}))
    try:
        yield
    finally:
        _MODEL = prev


@contextmanager
def stack(name: str):
    """Model code runs a stack whose sequence is not the residual's (an
    encoder's frames) inside ``stack(name)``, its checkpointed blocks too
    (their recomputes run in the backward, outside the forward's scope):
    ``seq_parallel`` then gives the ``model_parallel`` scope's answer for
    ``name``."""
    global _STACK
    prev, _STACK = _STACK, name
    try:
        yield
    finally:
        _STACK = prev


def model_group():
    """The ``model`` axis's process group, or ``None`` outside a scope or with
    one model rank."""
    mesh = _MODEL[0]
    if mesh is None or shd.axis_sizes(mesh)["model"] == 1:
        return None
    return mesh.get_group("model")


def layout():
    """The scope's ``sharding.ModelLayout``, or ``None`` where ``model_group``
    is: the layers then compute every product whole."""
    return None if model_group() is None else _MODEL[1]


def model_size() -> int:
    """The ``model`` axis's size (1 outside a scope)."""
    mesh = _MODEL[0]
    return 1 if mesh is None else shd.axis_sizes(mesh)["model"]


def model_index() -> int:
    """This rank's position on the ``model`` axis (its shard's block)."""
    mesh = _MODEL[0]
    return 0 if mesh is None else mesh.get_local_rank("model")


def all_reduce_f32(x, group):
    """``x`` summed over ``group`` in fp32 (a type below fp32 widened first),
    as a new fp32 tensor."""
    out = x.float() if x.dtype != torch.float32 else x.clone()
    dist.all_reduce(out, group=group)
    return out


def all_gather(x, dim: int, group):
    """The ranks' ``x`` joined along ``dim``, in rank order (no gradient):
    one all-gather into a buffer of the ranks' blocks, laid along ``dim``
    (a list of blocks would take one copy each, then their join: host time
    that a decode step pays in every layer)."""
    n = dist.get_world_size(group)
    x = x.contiguous()
    flat = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(flat, x, group=group)
    dim %= x.dim()
    if dim == 0:
        return flat
    shape = x.shape[:dim] + (n * x.shape[dim],) + x.shape[dim + 1:]
    return flat.reshape((n,) + tuple(x.shape)).movedim(0, dim).reshape(shape)


class _ToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_f32(grad, ctx.group).to(grad.dtype), None


class _FromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_f32(x, group).to(x.dtype)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def to_model(x):
    """Identity forward; the gradient summed over the model ranks. It goes
    before a partitioned product whose input every model rank holds."""
    group = model_group()
    return x if group is None else _ToModel.apply(x, group)


def from_model(x):
    """``x`` summed over the model ranks (in fp32, rounded once to its type);
    the gradient passed through."""
    group = model_group()
    return x if group is None else _FromModel.apply(x, group)


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, grad):
        n, rank = dist.get_world_size(ctx.group), dist.get_rank(ctx.group)
        return grad.chunk(n, dim=ctx.dim)[rank].contiguous(), None, None


def gather_from_model(x, dim: int):
    """The model ranks' blocks of ``x`` joined along ``dim``, in rank order;
    what follows must run alike on every rank, and the gradient of this rank's
    block is passed back."""
    group = model_group()
    return x if group is None else _GatherFromModel.apply(x, dim, group)


def model_max(x):
    """``x``'s elementwise maximum over the model ranks, without gradient."""
    group = model_group()
    if group is None:
        return x.detach()
    out = x.detach().clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
    return out


# ---------------------------------------------------------------------------
# sequence parallelism over ``model``
# ---------------------------------------------------------------------------

def seq_parallel() -> bool:
    """Whether the enclosing ``model_parallel`` scope splits the residual of
    the running stack (``stack``; the model's residual outside one) by
    sequence over more than one model rank."""
    split = _MODEL[3].get(_STACK, _MODEL[2])
    return bool(split) and model_group() is not None


def residual_len(batch) -> int:
    """The positions of a batch's residual: its tokens behind a VLM's prefix
    (an encoder-decoder's decoder tokens)."""
    return batch["tokens"].shape[1] + (batch["embeds"].shape[1] if "embeds" in batch else 0)


def residual_split(mesh, S: int) -> bool:
    """Whether a step over ``mesh`` splits a residual of ``S`` positions by
    sequence over ``model``: the enclosing activation scope's residual spec
    (``activation_sharding``) names ``model`` on the sequence dim, and tp
    divides ``S`` (where it does not, the residual stays whole, as
    ``sharding.sanitize_spec`` drops an axis that does not divide; the
    reference's XLA pads: ROADMAP C33). At one model rank the split is the
    identity."""
    act = current()
    spec = act.get("residual") if act is not None else None
    if spec is None or len(spec) < 2:
        return False
    names = spec[1] if isinstance(spec[1], tuple) else (spec[1],)
    return "model" in names and S % shd.axis_sizes(mesh)["model"] == 0


def seq_split(mesh, batch, splits: bool = True):
    """``(seq, stacks)`` of ``batch`` for ``model_parallel`` and
    ``sharding.compute_layout``, the one owner of the decision for the train
    step and the serving steps: ``residual_split`` of the residual
    (``residual_len``), and of each stack with a sequence of its own (an
    encoder-decoder's encoder, by its frames); every answer false where the
    step does not split the family's residual (``splits``: the train step
    passes whether the family takes its partitioned route; the serving steps
    split every family, ROADMAP C38 and C38b)."""
    seq = splits and residual_split(mesh, residual_len(batch))
    stacks = ({"encoder": splits and residual_split(mesh, batch["frames"].shape[1])}
              if "frames" in batch else {})
    return seq, stacks


def _seq_first(x):
    """``x`` (B, S, ...) as (S, B, ...), contiguous: a collective's dim 0."""
    return x.transpose(0, 1).contiguous()


class _SeqRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        n, rank = dist.get_world_size(group), dist.get_rank(group)
        return x.chunk(n, dim=1)[rank].clone()

    @staticmethod
    def backward(ctx, grad):
        return all_gather(grad, 1, ctx.group), None


class _SeqGatherF32(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.dtype = group, x.dtype
        return all_gather(x, 1, group).float()

    @staticmethod
    def backward(ctx, grad):
        whole = _seq_first(grad.float())
        out = whole.new_empty((whole.shape[0] // dist.get_world_size(ctx.group),)
                              + whole.shape[1:])
        dist.reduce_scatter_tensor(out, whole, group=ctx.group)
        return out.transpose(0, 1).to(ctx.dtype), None


def columns_to_rows(y, group):
    """(B, S, N/n) of this rank's columns -> (B, S/n, N) of its rows: the
    all-to-all of ``seq_columns_to_rows``, with no gradient."""
    n = dist.get_world_size(group)
    B, S, c = y.shape
    send = y.reshape(B, n, S // n, c).transpose(0, 1).contiguous()   # by row block
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)                 # by column block
    return recv.permute(1, 2, 0, 3).reshape(B, S // n, n * c)


def _rows_to_columns(x, group):
    """The inverse of ``columns_to_rows``: (B, S/n, N) -> (B, S, N/n)."""
    n = dist.get_world_size(group)
    B, s, N = x.shape
    send = x.reshape(B, s, n, N // n).permute(2, 0, 1, 3).contiguous()  # by column block
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)                    # by row block
    return recv.transpose(0, 1).reshape(B, n * s, N // n)


class _SeqColumnsToRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, group):
        ctx.group = group
        return columns_to_rows(y, group)

    @staticmethod
    def backward(ctx, grad):
        return _rows_to_columns(grad, ctx.group), None


class _SeqRowsOfSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        whole = _seq_first(x)
        out = whole.new_empty((whole.shape[0] // dist.get_world_size(group),)
                              + whole.shape[1:])
        dist.reduce_scatter_tensor(out, whole, group=group)
        return out.transpose(0, 1).contiguous()

    @staticmethod
    def backward(ctx, grad):
        return all_gather(grad, 1, ctx.group), None


def seq_rows(x):
    """This model rank's rows (its block of ``S/tp``) of ``x``, which every rank holds
    whole; the rows' gradients are all-gathered back into the whole one."""
    return _SeqRows.apply(x, model_group()) if seq_parallel() else x


def seq_gather(x):
    """The model ranks' rows of ``x`` joined into the whole sequence, alike on
    every rank (``gather_from_model(x, 1)``), for a token mixer that needs the
    whole sequence and runs alike on every rank up to its split products
    (whose inputs' partial gradients ``layers.whole_input`` sums); the rank
    keeps its rows of the whole gradient. ``x`` itself where
    ``seq_parallel()`` is false."""
    return gather_from_model(x, 1) if seq_parallel() else x


def seq_gather_f32(x):
    """The model ranks' rows of ``x`` gathered into the whole sequence (in
    ``x``'s type, then widened to fp32: the same values); the gradient, each
    rank's fp32 partial of the whole, is reduce-scattered back to the rows and
    rounded once to ``x``'s type. It goes before products that each rank
    computes on its own columns over the whole sequence."""
    return _SeqGatherF32.apply(x, model_group()) if seq_parallel() else x


def seq_columns_to_rows(y):
    """``y`` (B, S, N/tp), this rank's output columns of the whole sequence, as
    (B, S/tp, N), the whole columns of its rows: an all-to-all, whose backward
    is the inverse all-to-all. Values move; nothing is summed."""
    return _SeqColumnsToRows.apply(y, model_group()) if seq_parallel() else y


def join_columns(y):
    """The model ranks' blocks of ``y``'s last dim joined
    (``gather_from_model(y, -1)``), or under sequence parallelism turned into
    this rank's rows of the whole columns (``seq_columns_to_rows``)."""
    return seq_columns_to_rows(y) if seq_parallel() else gather_from_model(y, -1)


def seq_last(x):
    """The whole sequence's last position of ``x`` (B, S, ...), as (B, 1, ...)
    on every model rank: under sequence parallelism, where ``x`` is this
    rank's rows, the last model rank's last row (each rank's last row
    gathered over ``model``, B rows a rank where gathering ``x`` would move
    S/tp of them, and the last rank's kept; no gradient); ``x[:, -1:]``
    elsewhere."""
    last = x[:, -1:]
    return all_gather(last, 1, model_group())[:, -1:] if seq_parallel() else last


def seq_rows_of_sum(x):
    """The model ranks' ``x`` summed and this rank's rows kept (a
    reduce-scatter), for terms of which at most one rank's is not zero at each
    element, so that the sum is exact (the vocabulary-parallel lookup); the
    rows' gradients are all-gathered back into the whole one."""
    return _SeqRowsOfSum.apply(x, model_group()) if seq_parallel() else x


# ---------------------------------------------------------------------------
# serving: the cache's blocks, the greedy token, a decode group over ``data``
# ---------------------------------------------------------------------------

# process-wide like the others: (mesh, sharding.CacheBlock) of the cache the
# serving step reads and writes, or None
_CACHE = None


@contextmanager
def serving_cache(mesh, block):
    """Within the scope the model serves from this rank's ``block``
    (``sharding.CacheBlock``) of a cache placed over ``mesh``: a prefill
    builds that block, and a decode step attends over it, merging the
    blocks' partials over ``block.seq_axes`` (``cache_seq_gather``)."""
    global _CACHE
    prev, _CACHE = _CACHE, (mesh, block)
    try:
        yield
    finally:
        _CACHE = prev


def cache_block():
    """The enclosing ``serving_cache`` scope's ``sharding.CacheBlock``, or ``None``."""
    return None if _CACHE is None else _CACHE[1]


def cache_seq_gather(x, axes):
    """``x`` of every rank whose block of a cache's sequence differs from
    this one's (the ``axes`` that split it, a ``CacheBlock``'s ``seq_axes``),
    stacked on a new leading dim, this rank's among them (an all-gather over
    each axis in turn): a decode step's partials of each block, for their
    merge. ``x[None]`` where no axis splits the sequence."""
    mesh = _CACHE[0]
    out = x[None]
    for a in reversed(axes):
        out = all_gather(out, 0, mesh.get_group(a))
    return out


def vocab_argmax(logits):
    """The greedy token of ``logits`` (..., V/tp), this model rank's block of
    a vocabulary split over ``model`` (``torch.argmax``'s over the whole
    vocabulary where none is): each rank's largest logit and its first index,
    the pairs all-gathered over ``model`` (two numbers a row, where gathering
    the logits would move V of them), and the first rank holding the largest.
    The ranks' blocks lie in rank order, so the token is one device's
    ``torch.argmax``, the first index on a tie. Int64, without the last dim."""
    lay = layout()
    if lay is None or not lay.vocab:
        return torch.argmax(logits, dim=-1)
    group = model_group()
    local = torch.argmax(logits, dim=-1, keepdim=True)
    best = torch.cat([logits.gather(-1, local).float(),
                      (local + model_index() * logits.shape[-1]).float()], dim=-1)
    every = all_gather(best[None], 0, group)                    # (tp, ..., 2)
    rank = torch.argmax(every[..., 0], dim=0, keepdim=True)     # the first of the largest
    return every[..., 1].gather(0, rank)[0].long()


def data_gather(x):
    """The data ranks' ``x`` joined along dim 0 in their batch order
    (``data_index``), over the enclosing ``data_parallel`` scope's mesh, no
    gradient: a decode group spanning the data ranks. ``x`` outside a scope
    or with one data rank."""
    mesh = data_mesh()
    if mesh is None:
        return x
    sizes = shd.axis_sizes(mesh)
    for a in reversed(shd.fsdp_axes(mesh)):
        if sizes[a] > 1:
            x = all_gather(x, 0, mesh.get_group(a))
    return x


def data_rows(x, n: int):
    """This data rank's ``n`` rows of ``x``, the data ranks' rows joined
    (``data_gather``)."""
    mesh = data_mesh()
    return x if mesh is None else x.narrow(0, data_index(mesh) * n, n)
