"""Per-cell planning: meta-tensor inputs, placements and step functions for
every (arch x shape x mesh) cell.

``plan_cell`` applies the memory napkin math (``HBM_BUDGET`` a device) to
choose microbatch count, optimizer-state dtype, and activation
sequence-sharding, with the reference's arithmetic; ``PERF_OVERRIDES`` holds
the reference's tuned plans, applied under its ``REPRO_PERF=1`` switch.

``build_cell`` gives the reference's keys: ``fn`` (the port's step, inside
the activation scope), ``args`` (meta tensors: shapes and dtypes, no memory),
``in_shardings`` (trees of ``DTensor`` placements on the given mesh; spec and
placements leaves are tuples, ``sharding.is_spec``), ``donate``, ``plan`` and
``meta``. The train step takes its state as ``DTensor``s on a ``DeviceMesh``
(``trainer.make_train_step(..., mesh=)``); it brings each gradient back in its
parameter's placements whatever ``grad_acc_sharded`` says, as the reference
does with that knob on. A serving cell hands over the sharded serving
steps (``serve.decode``'s ``mesh=``, ``seq_shard`` the plan's
``seq_shard_cache``), its parameters placed in the serving layout
(``sharding.serve_specs``: whole over the data axes, where the reference
places them by ``param_specs``; a Mamba2 layer's fused leaves rank-major,
``sharding.rank_major``), its cache as ``sharding.serve_cache_specs`` says
(``cache_specs``, a Mamba2 conv state rank-major). A prefill cell whose plan
sets ``seq_shard_acts`` (``REPRO_PERF``'s command-r-plus-104b
``prefill_32k``, or ``--set seq_shard_acts=true``) runs in a scope whose
residual spec names ``model`` on the sequence dim, and the sharded prefill
of every family then splits its residual by sequence
(``serve.decode.seq_split``; ROADMAP C38, C38b).
"""
from __future__ import annotations

import dataclasses
import math
import os
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch import tree
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import api
from repro_torch.parallel import ctx as pctx
from repro_torch.parallel import sharding as shd
from repro_torch.serve import decode as serve_decode
from repro_torch.train import optimizer as opt
from repro_torch.train import trainer

# one device's memory for a cell's plan: the total_memory that
# torch.cuda.get_device_properties(0) reads on an NVIDIA H100 80GB HBM3
# (power limit 700.00 W), 85,017,493,504 bytes, less about 8 GB of headroom
HBM_BUDGET = 77.0e9


@dataclass(frozen=True)
class CellPlan:
    microbatches: int = 1
    remat: str = "full"
    moe_impl: str = "einsum"
    moe_sharding: str = "auto"
    opt_dtype: str = "float32"
    grad_dtype: str = "float32"
    seq_shard_acts: bool = False
    seq_shard_cache: bool = False      # SP for long-context decode
    loss_chunk: int = 2048
    # §Perf knobs (enabled per-cell through PERF_OVERRIDES; the defaults
    # are the paper-faithful baseline)
    cast_params: str = "none"          # bf16 fwd/bwd params
    grad_acc_sharded: bool = False     # reduce-scatter grads onto FSDP shards
    attn_chunk: int = 512              # flash KV chunk size
    attn_pv_bf16: bool = False         # FA3-style P tile FP32->bf16 for P@V
    moe_token_local: bool = False      # pin MoE dispatch buffers to token
                                       # sharding
    notes: str = ""


# (arch, shape, mesh) -> overrides, applied only when REPRO_PERF=1. The data
# is the reference's: the overrides were tuned in its dry-run for its TPU
# meshes and are untested on an H100.
PERF_OVERRIDES: Dict[Tuple[str, str, str], Dict[str, Any]] = {
    ("grok-1-314b", "train_4k", "16x16"): {"microbatches": 8},
    ("grok-1-314b", "train_4k", "2x16x16"): {"microbatches": 4},
    ("command-r-plus-104b", "train_4k", "16x16"): {"microbatches": 2},
    ("command-r-plus-104b", "train_4k", "2x16x16"): {"microbatches": 2},
    ("command-r-plus-104b", "prefill_32k", "16x16"): {
        "seq_shard_acts": True, "attn_chunk": 2048, "attn_pv_bf16": True},
    ("command-r-plus-104b", "prefill_32k", "2x16x16"): {
        "seq_shard_acts": True, "attn_chunk": 2048, "attn_pv_bf16": True},
}


def plan_cell(cfg: ModelConfig, shape: ShapeConfig, mesh) -> CellPlan:
    sizes = shd.axis_sizes(mesh)
    n_dev = math.prod(sizes.values())
    fsdp = shd.fsdp_size(mesh)
    tp = sizes["model"]
    plan = CellPlan()
    if shape.kind == "train":
        n_params = cfg.param_count()
        # params fp32 + grads fp32 + adam m/v
        opt_dtype = "float32"
        per_param = 4 + 4 + 8
        if n_params * per_param / n_dev > 0.7 * HBM_BUDGET:
            opt_dtype = "bfloat16"
            per_param = 4 + 4 + 4
        fixed = n_params * per_param / n_dev
        # sequence-parallel residual stream by default: saved remat carries
        # shard over ('model') too
        seq_shard = True
        # ssm/hybrid token-mixers need the whole sequence per layer (token
        # shift / conv / scan): intra-layer activations only shard over DP,
        # and run several fp32 passes -> much larger per-token constant
        if cfg.family in ("ssm", "hybrid"):
            tokens_local = shape.tokens / fsdp
            act_per_tok = cfg.d_model * 4 * 10
        else:
            tokens_local = shape.tokens / fsdp / tp
            act_per_tok = cfg.d_model * 2 * (cfg.num_layers + 8) * 3
        budget = max(HBM_BUDGET - fixed, 1e9)
        mb = 1
        while mb < 64 and tokens_local / mb * act_per_tok > budget:
            mb *= 2
        mb = min(mb, int(max(1, shape.global_batch // fsdp)))
        grad_dtype = "float32"
        if n_params * (per_param + 8) / n_dev > HBM_BUDGET:
            grad_dtype = "bfloat16"   # accumulate grads in bf16 (giant MoE)
        plan = dataclasses.replace(
            plan, microbatches=mb, opt_dtype=opt_dtype, grad_dtype=grad_dtype,
            seq_shard_acts=seq_shard)
    elif shape.kind == "decode" and shape.global_batch < fsdp:
        # batch can't fill the data axis -> shard the KV sequence instead
        plan = dataclasses.replace(plan, seq_shard_cache=True)
    if os.environ.get("REPRO_PERF") == "1":
        key = (cfg.name, shape.name, "x".join(map(str, sizes.values())))
        if key in PERF_OVERRIDES:
            plan = dataclasses.replace(plan, **PERF_OVERRIDES[key])
    return plan


# ---------------------------------------------------------------------------
# abstract inputs
# ---------------------------------------------------------------------------

def _meta(shape, dtype):
    return torch.empty(tuple(int(x) for x in shape), dtype=dtype, device="meta")


def batch_struct(cfg: ModelConfig, shape: ShapeConfig, *, kind: str):
    B, S = shape.global_batch, shape.seq_len
    s_tok = S
    out = {}
    if cfg.family == "vlm":
        s_tok = S - cfg.frontend_len
        out["embeds"] = _meta((B, cfg.frontend_len, cfg.d_model), torch.bfloat16)
    if cfg.family == "encdec":
        out["frames"] = _meta((B, cfg.frontend_len, cfg.d_model), torch.bfloat16)
    out["tokens"] = _meta((B, s_tok), torch.int32)
    if kind == "train":
        out["labels"] = _meta((B, s_tok), torch.int32)
    return out


def _cast_float(struct, dtype):
    return tree.map_leaves(
        lambda x: x.to(dtype) if torch.is_floating_point(x) else x, struct)


def _placed(specs, mesh):
    return tree.map_leaves(lambda s: shd.placements(s, mesh), specs, is_leaf=shd.is_spec)


def _activation_kinds(plan: CellPlan, mesh, cfg=None):
    """The activation scope's specs of a cell's plan on ``mesh``
    (``parallel.ctx.activation_sharding``'s keywords)."""
    dp = shd.fsdp_axes(mesh)
    dpa = dp if len(dp) > 1 else dp[0]
    residual = (dpa, "model" if plan.seq_shard_acts else None, None)
    residual_dec = (None if plan.seq_shard_cache else dpa, None, None)
    kinds = dict(residual=residual, residual_dec=residual_dec)
    if plan.moe_token_local:
        # dispatched expert buffers (n_groups, E, cap, d): groups carry the
        # flattened token dim -> same axes the residual tokens shard over
        tok = (tuple(dp) + ("model",)) if plan.seq_shard_acts else dpa
        kinds["moe_tokens"] = (tok, None, None, None)
    if cfg is not None and cfg.num_kv_heads:
        heads_div = cfg.num_kv_heads % shd.axis_sizes(mesh)["model"] == 0
        if heads_div:
            # collected prefill KV: (B, S, Hkv, D) heads over model
            kinds["kv_collect"] = (dpa, None, "model", None)
        else:
            # seq over model; decode scores stay sharded on S
            kinds["kv_collect"] = (dpa, "model", None, None)
            kinds["scores_dec"] = (
                None if plan.seq_shard_cache else dpa, None, None, None, "model")
    return kinds


def _with_activation_ctx(fn, plan: CellPlan, mesh, cfg=None):
    kinds = _activation_kinds(plan, mesh, cfg)

    def wrapped(*args):
        with pctx.activation_sharding(**kinds):
            return fn(*args)

    return wrapped


def prefill_split(cfg: ModelConfig, shape: ShapeConfig, mesh, plan: CellPlan):
    """``(seq, stacks)`` of a prefill cell's sharded step inside the cell's
    activation scope: whether it splits the residual (an encoder's frames)
    by sequence (``serve.decode.seq_split``)."""
    with pctx.activation_sharding(**_activation_kinds(plan, mesh, cfg)):
        return serve_decode.seq_split(cfg, mesh, batch_struct(cfg, shape, kind="prefill"))


def build_cell(cfg: ModelConfig, shape: ShapeConfig, mesh,
               plan: Optional[CellPlan] = None):
    """Returns dict(fn, args (meta tensors), in_shardings (placements trees),
    donate, plan, meta)."""
    plan = plan or plan_cell(cfg, shape, mesh)

    param_struct = api.init(cfg, device="meta")
    pspecs = shd.param_specs(cfg, param_struct, mesh, moe_sharding=plan.moe_sharding)
    pshard = _placed(pspecs, mesh)
    dspec = shd.data_specs(cfg, shape.kind, mesh, batch=shape.global_batch)
    bstruct = batch_struct(cfg, shape, kind=shape.kind)
    bshard = {k: shd.placements(shd.sanitize_spec(dspec[k], bstruct[k].shape, mesh), mesh)
              for k in bstruct}

    if shape.kind == "train":
        run = trainer.RunConfig(
            microbatches=plan.microbatches, remat=plan.remat,
            moe_impl=plan.moe_impl, loss_chunk=plan.loss_chunk,
            grad_dtype=plan.grad_dtype, cast_params=plan.cast_params,
            attn_chunk=plan.attn_chunk, attn_pv_bf16=plan.attn_pv_bf16,
            opt=opt.OptConfig())
        step = _with_activation_ctx(trainer.make_train_step(cfg, run, mesh=mesh),
                                    plan, mesh, cfg)
        m_struct = _cast_float(param_struct, getattr(torch, plan.opt_dtype))
        state_struct = trainer.TrainState(
            params=param_struct,
            opt_state=opt.OptState(m=m_struct, v=m_struct, step=_meta((), torch.int32)),
            ef_error=None)
        state_shard = trainer.TrainState(
            params=pshard,
            opt_state=opt.OptState(m=pshard, v=pshard,
                                   step=shd.placements((), mesh)),
            ef_error=None)
        return dict(
            fn=step, args=(state_struct, bstruct),
            in_shardings=(state_shard, bshard),
            donate=(0,), plan=plan,
            meta=dict(kind="train", tokens=shape.tokens))

    # the serving layout: whole over the data axes, Segments leaves rank-major
    serve_params = shd.rank_major(cfg, _cast_float(param_struct, torch.bfloat16), mesh)
    pshard = _placed(shd.serve_specs(cfg, param_struct, mesh), mesh)
    step_mesh = dict(mesh=mesh, seq_shard=plan.seq_shard_cache)

    if shape.kind == "prefill":
        step = _with_activation_ctx(
            serve_decode.make_prefill_step(
                cfg, max_seq=shape.seq_len, remat=plan.remat,
                attn_chunk=plan.attn_chunk, cast_params=plan.cast_params,
                attn_pv_bf16=plan.attn_pv_bf16, **step_mesh),
            plan, mesh, cfg)
        return dict(
            fn=step, args=(serve_params, bstruct),
            in_shardings=(pshard, bshard),
            donate=(), plan=plan,
            meta=dict(kind="prefill", tokens=shape.tokens))

    # decode: one new token against a full cache
    B, S = shape.global_batch, shape.seq_len
    cache_struct = shd.rank_major_cache(
        cfg, api.init_cache(cfg, B, S, dtype=torch.bfloat16, device="meta"), mesh)
    parts = {k: v for k, v in cache_struct.items() if k != "idx"}  # idx, a host int, has none
    cshard = tree.rebuild(parts, [shd.placements(spec, mesh) for spec in shd.serve_cache_specs(
        cfg, mesh, batch=B, max_seq=S, seq_shard=plan.seq_shard_cache)])
    tok_struct = _meta((B, 1), torch.int32)
    tok_shard = shd.placements((None,) if plan.seq_shard_cache else shd.batch_spec(mesh),
                               mesh)
    step = _with_activation_ctx(serve_decode.make_serve_step(cfg, **step_mesh), plan, mesh,
                                cfg)
    return dict(
        fn=step, args=(serve_params, cache_struct, tok_struct),
        in_shardings=(pshard, cshard, tok_shard),
        donate=(1,), plan=plan,
        meta=dict(kind="decode", tokens=B))
