"""Train step factory: microbatched gradient accumulation, remat, MoE aux loss
and a gradient compression hook, on one device or sharded over a mesh.

``make_train_step(cfg, run)`` returns a function
    train_step(state, batch) -> (state, metrics)
that takes one optimizer step. Parameters are fp32 master tensors with
``requires_grad``; ``run.cast_params`` casts them (differentiably) to the
compute type inside the loss. The step updates the state's tensors in place
(see ``optimizer.apply_updates``) and returns the state. Metrics are 0-d
tensors: reading one waits for the card.

``make_train_step(cfg, run, mesh=mesh)`` is the sharded step, the counterpart
of the reference's GSPMD step with ``grad_specs``. Parameters and moments are
``DTensor``s placed by ``parallel.sharding.param_specs`` (``shard_state``);
the batch is ``DTensor``s sharded over the data axes (``shard_batch``). Each
rank runs the loss and the kernels on plain tensors over its own rows (inside
``parallel.ctx.data_parallel``, so the loss's token count and the MoE
load-balance statistics are the global batch's), and the gradient comes back
summed over the data axes and reduce-scattered into the parameter's
placements; the optimizer updates each rank's shards. Every family takes the
partitioned route (``route``): each parameter is gathered over the data axes
and placed over ``model`` as ``parallel.sharding.compute_layout`` says (a
leaf the layout does not split, such as an attention leaf whose shard would
not fall on head boundaries, is gathered over ``model`` too; a Mamba2 layer's
fused ``in_proj`` is gathered and cut to this rank's columns,
``sharding.Segments``). The loss runs inside ``parallel.ctx.model_parallel``
with the same ``sharding.model_layout``: heads (attention, Mamba2 and RWKV6
heads), ``d_ff``, the vocabulary and the experts (or each expert's ``d_ff``)
are partitioned over ``model``, as the reference's GSPMD step partitions
them, in column-parallel products.

``"gathered"`` is the route of the first sharded step (ROADMAP C25), kept as
the yardstick ``tests/test_torch_cost.py`` counts the partitioned route
against and reached by no family: every parameter is gathered with
``full_tensor``, and every model rank of a data row computes that row at
full width; only the state at rest is sharded over ``model``.

Every family of the registry is ported (an encdec batch carries its
``frames``); ``init_state`` and ``make_loss_fn`` raise ``NotImplementedError``
for a family the port has no model of.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from functools import partial
from typing import NamedTuple, Optional, Union

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard, distribute_tensor

from repro_torch import tree
from repro_torch.models import api, layers
from repro_torch.models.attention import knob_attention
from repro_torch.parallel import ctx as pctx
from repro_torch.parallel import sharding as shd
from repro_torch.train import optimizer as opt
from repro_torch.train.loss import chunked_cross_entropy


PARTITIONED_FAMILIES = ("dense", "vlm", "moe", "hybrid", "ssm", "encdec")


def route(cfg) -> str:
    """The sharded step's route for ``cfg``'s family (the module's docstring)."""
    return "partitioned" if cfg.family in PARTITIONED_FAMILIES else "gathered"


@dataclass(frozen=True)
class RunConfig:
    microbatches: int = 1
    remat: str = "full"
    moe_impl: str = "einsum"
    moe_aux_weight: float = 0.01
    loss_chunk: int = 2048
    grad_dtype: str = "float32"        # gradient accumulator dtype
    grad_compress: str = "none"        # none | int8 (error-feedback)
    cast_params: str = "none"          # none | bfloat16: fwd/bwd compute
                                       # params (fp32 masters kept in state)
    attn_chunk: int = 512              # flash_ref KV chunk (§Perf knob)
    attn_pv_bf16: bool = False         # FA3-style P-tile cast (§Perf knob);
                                       # attention.knob_attention maps both
    opt: opt.OptConfig = opt.OptConfig()


class TrainState(NamedTuple):
    params: dict
    opt_state: opt.OptState
    ef_error: Optional[dict]           # int8 compression error feedback


def init_state(cfg, run: RunConfig, seed: Union[int, torch.Generator] = 0, *,
               device="cuda") -> TrainState:
    """Seeded fp32 parameters with ``requires_grad`` on ``device``, zero moments."""
    params = api.init(cfg, seed, device=device)
    for p in tree.leaves(params):
        p.requires_grad_(True)
    ef = (tree.map_leaves(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                device=p.device), params)
          if run.grad_compress == "int8" else None)
    return TrainState(params=params, opt_state=opt.init(params), ef_error=ef)


def _quantize_int8(g, err):
    """Error-feedback int8 compression: models a compressed gradient
    all-reduce (the quantize->sum->dequantize pipeline); the quantization
    residual is fed back into the next step."""
    gf = g.float() + err
    scale = torch.clamp(torch.max(torch.abs(gf)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(gf / scale), -127, 127)
    deq = q * scale
    return deq, gf - deq


def make_loss_fn(cfg, run: RunConfig, mode: Optional[str] = None):
    """loss_fn(params, mb) -> (total, {"loss", "aux"}): total is the loss plus
    ``moe_aux_weight`` times the MoE load-balance loss. ``mode`` is handed to
    ``kernels.ops`` (``"reference"`` forces the plain attention).

    ``cast_params`` casts every floating leaf, the MoE router too, as the
    reference's loss does (``transformer.cast_params``, used for serving,
    keeps the router fp32)."""
    api.require_ported(cfg)

    def loss_fn(params, mb):
        attn_fn = knob_attention(run.attn_chunk, run.attn_pv_bf16,
                                 device=mb["labels"].device,
                                 dtype=layers.to_dtype(cfg.compute_dtype), mode=mode)
        if run.cast_params != "none":
            cdt = layers.to_dtype(run.cast_params)
            params = tree.map_leaves(
                lambda p: p.to(cdt) if torch.is_floating_point(p) else p, params)
        hidden, aux = api.forward_hidden(cfg, params, mb, remat=run.remat,
                                         moe_impl=run.moe_impl, attn_fn=attn_fn,
                                         mode=mode)
        s_tok = mb["labels"].shape[1]
        loss, _ = chunked_cross_entropy(
            hidden[:, -s_tok:], api.unembed_table(cfg, params), mb["labels"],
            chunk=run.loss_chunk)
        aux = torch.as_tensor(aux, dtype=torch.float32, device=loss.device)
        return loss + run.moe_aux_weight * aux, {"loss": loss, "aux": aux}
    return loss_fn


def shard_state(cfg, state: TrainState, mesh) -> TrainState:
    """``state`` with its parameters and moments as ``DTensor``s placed by
    ``param_specs`` on ``mesh`` (each rank keeps its shards of the full tensors
    it holds: no communication). The step count stays a plain tensor."""
    if state.ef_error is not None:
        raise NotImplementedError("grad_compress='int8' has no sharded step")
    specs = tree.leaves(shd.param_specs(cfg, state.params, mesh), is_leaf=shd.is_spec)

    def place(t, requires_grad):
        return tree.rebuild(t, [
            distribute_tensor(x.detach(), mesh, shd.placements(s, mesh),
                              src_data_rank=None).requires_grad_(requires_grad)
            for x, s in zip(tree.leaves(t), specs)])

    o = state.opt_state
    return TrainState(place(state.params, True),
                      o._replace(m=place(o.m, False), v=place(o.v, False)), None)


def shard_batch(batch, mesh, microbatches: int = 1):
    """The global ``batch`` (every rank holds all of it) as ``DTensor``s
    sharded by ``batch_spec`` over the data axes. With microbatches, the rows
    are first ordered so that microbatch i of every rank holds its share of
    the global batch's microbatch i (rows i·b to (i+1)·b), as the
    single-device step splits it."""
    pl = shd.placements(shd.batch_spec(mesh), mesh)
    n_data = shd.fsdp_size(mesh)

    def place(x):
        if x.shape[0] % (n_data * microbatches):
            raise ValueError(f"a batch of {x.shape[0]} rows does not split into "
                             f"{microbatches} microbatch(es) over {n_data} data rank(s)")
        if microbatches > 1:
            x = x.reshape((microbatches, n_data, -1) + x.shape[1:]).transpose(0, 1)
            x = x.reshape((-1,) + x.shape[3:])
        return distribute_tensor(x, mesh, pl, src_data_rank=None)

    return {k: place(v) for k, v in batch.items()}


def _partitioned_gather(cfg, params, mesh):
    """The plain tensors the partitioned loss computes with, one a leaf of
    ``params`` (DTensors): each leaf gathered over the data axes, in its
    ``compute_layout`` over ``model``, its gradient coming back summed over
    the data axes and, over ``model``, as the layout says. A ``Segments``
    entry (a Mamba2 layer's fused ``in_proj``) gathers the leaf over ``model``
    and keeps this rank's columns of it, a copy: the whole leaf is not held
    past the gather."""
    names, fsdp = shd.axis_names(mesh), shd.fsdp_axes(mesh)
    tp, rank = shd.axis_sizes(mesh)["model"], mesh.get_local_rank("model")
    out = []
    for p, (spec, grad) in zip(tree.leaves(params), shd.compute_layout(cfg, params, mesh)):
        model = next((Shard(i) for i, e in enumerate(spec) if e == "model"), Replicate())
        model_grad = {"shard": model, "sum": Partial("sum"), "same": Replicate()}[grad]
        compute = tuple(model if n == "model" else Replicate() for n in names)
        grad_pl = tuple(Partial("sum") if n in fsdp else model_grad if n == "model"
                        else Replicate() for n in names)
        t = p.redistribute(mesh, compute).to_local(grad_placements=grad_pl)
        for dim, e in enumerate(spec):
            if isinstance(e, shd.Segments):
                t = e.take(t, dim, tp, rank)
        out.append(t)
    return out


def make_train_step(cfg, run: RunConfig, mode: Optional[str] = None, mesh=None):
    """One optimizer step; sharded over ``mesh`` when one is given (see the
    module's docstring)."""
    loss_fn = make_loss_fn(cfg, run, mode=mode)
    gather = None
    scope = contextlib.nullcontext
    if mesh is not None:
        if run.grad_compress != "none":
            raise NotImplementedError(f"grad_compress={run.grad_compress!r} has no "
                                      "sharded step")
        fsdp = shd.fsdp_axes(mesh)
        batch_pl = shd.placements(shd.batch_spec(mesh), mesh)
        if route(cfg) == "partitioned":
            scope = partial(pctx.model_parallel, mesh,
                            shd.model_layout(cfg, shd.axis_sizes(mesh)["model"]))

            def gather(params, leaves):
                return _partitioned_gather(cfg, params, mesh)
        else:
            # each data rank's loss is its share of the global loss (the ranks'
            # terms add up to it); every model rank of a data row computes the same
            grad_pl = tuple(Partial("sum") if a in fsdp else Replicate()
                            for a in shd.axis_names(mesh))

            def gather(params, leaves):
                return [p.full_tensor(grad_placements=grad_pl) for p in leaves]

    def grads_of(params, mb):
        leaves = tree.leaves(params)
        full = leaves if gather is None else gather(params, leaves)
        # the backward's checkpointed recomputes run the model again: in the scope
        with scope():
            total, metrics = loss_fn(tree.rebuild(params, full), mb)
            return torch.autograd.grad(total, leaves, allow_unused=True,
                                       materialize_grads=True), metrics

    def local_rows(batch):
        for k, v in batch.items():
            if not isinstance(v, DTensor) or tuple(v.placements) != batch_pl:
                raise ValueError(f"batch[{k!r}]: the sharded step takes DTensors placed "
                                 f"{batch_pl} (shard_batch), not {type(v).__name__} "
                                 f"{getattr(v, 'placements', '')}")
        return {k: v.to_local() for k, v in batch.items()}

    def train_step(state: TrainState, batch):
        if mesh is None:
            return step(state, batch)
        with pctx.data_parallel(mesh):
            state, metrics = step(state, local_rows(batch))
            for k in ("loss", "aux"):
                metrics[k] = pctx.data_sum(metrics[k])
        return state, metrics

    def step(state: TrainState, batch):
        params = state.params
        n_mb = run.microbatches

        if n_mb == 1:
            grads, metrics = grads_of(params, batch)
        else:
            b = next(iter(batch.values())).shape[0] // n_mb
            gdt = layers.to_dtype(run.grad_dtype)
            grads = [torch.zeros_like(p, dtype=gdt) for p in tree.leaves(params)]
            ms = []
            for i in range(n_mb):
                g, m = grads_of(params, {k: v[i * b:(i + 1) * b] for k, v in batch.items()})
                torch._foreach_add_(grads, [x.to(gdt) for x in g])
                ms.append(m)
            torch._foreach_div_(grads, float(n_mb))
            metrics = {k: torch.stack([m[k] for m in ms]).mean() for k in ms[0]}

        ef = state.ef_error
        if run.grad_compress == "int8":
            pairs = [_quantize_int8(g, e) for g, e in zip(grads, tree.leaves(ef))]
            grads = [deq for deq, _ in pairs]
            ef = tree.rebuild(ef, [res for _, res in pairs])

        params, new_opt, om = opt.apply_updates(
            run.opt, params, tree.rebuild(params, grads), state.opt_state)
        metrics = {k: v.detach() for k, v in dict(metrics, **om).items()}
        return TrainState(params, new_opt, ef), metrics

    return train_step
