"""Train step factory: microbatched gradient accumulation, remat, MoE aux loss
and a gradient compression hook, on one device.

``make_train_step(cfg, run)`` returns a function
    train_step(state, batch) -> (state, metrics)
that takes one optimizer step. Parameters are fp32 master tensors with
``requires_grad``; ``run.cast_params`` casts them (differentiably) to the
compute type inside the loss. The step updates the state's tensors in place
(see ``optimizer.apply_updates``) and returns the state. Metrics are 0-d
tensors: reading one waits for the card.

The reference's ``grad_specs`` (the gradient accumulator's sharding) has no
counterpart: one card has nothing to shard. Every family of the registry is
ported (an encdec batch carries its ``frames``); ``init_state`` and
``make_loss_fn`` raise ``NotImplementedError`` for a family the port has no
model of.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Union

import torch

from repro_torch import tree
from repro_torch.models import api, layers
from repro_torch.models.attention import knob_attention
from repro_torch.train import optimizer as opt
from repro_torch.train.loss import chunked_cross_entropy


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


def make_train_step(cfg, run: RunConfig, mode: Optional[str] = None):
    loss_fn = make_loss_fn(cfg, run, mode=mode)

    def grads_of(params, mb):
        total, metrics = loss_fn(params, mb)
        return torch.autograd.grad(total, tree.leaves(params), allow_unused=True,
                                   materialize_grads=True), metrics

    def train_step(state: TrainState, batch):
        params = state.params
        n_mb = run.microbatches

        if n_mb == 1:
            grads, metrics = grads_of(params, batch)
        else:
            b = next(iter(batch.values())).shape[0] // n_mb
            gdt = layers.to_dtype(run.grad_dtype)
            grads = [torch.zeros(p.shape, dtype=gdt, device=p.device)
                     for p in tree.leaves(params)]
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
