"""Loss: chunked-vocab cross entropy.

The (T, V) logits matrix is never materialized for the whole batch: the final
projection and log-sum-exp run per token chunk, and each chunk's body runs
under ``torch.utils.checkpoint``, so its logits are dropped after the forward
and made again in the backward pass. The peak stays at (chunk, V), as the
reference's ``jax.checkpoint``-ed scan body keeps it.
"""
from __future__ import annotations

from functools import partial

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models import layers
from repro_torch.parallel import ctx as pctx


class _LogitsMatmul(torch.autograd.Function):
    """``hidden @ w_unembed`` from bf16 operands, with the reference's roundings.

    The reference writes ``(h.astype(bf16) @ w.astype(bf16)).astype(f32)``, and
    XLA folds the widening convert into the dot, so the logits it computes are
    never rounded to bf16 (the products are summed and kept in fp32, as the
    MXU gives them); the same holds for the gradient of ``h``, while the
    gradient of ``w`` comes out rounded to bf16 (observed on XLA's CPU backend,
    which the parity tests run). This function does that arithmetic: with the
    logits rounded to bf16, as the source reads, the step-1 gradients miss the
    reference's by more than the 1e-4 that ``tests/test_torch_train.py`` holds
    them to.

    Inside ``parallel.ctx.data_parallel`` the gradient of ``w`` is summed over
    the data ranks in fp32 before it is rounded, and only data rank 0 passes it
    on (the sharded step adds the ranks' gradients): the global batch's
    gradient is rounded once, as on one device. Rounded on each rank, the
    partial sums put a sharded run ~2^-9 of a partial away from the
    single-device run (ROADMAP C26).
    """

    @staticmethod
    def forward(ctx, h, w, model_group=None):
        hb, wb = h.to(torch.bfloat16), w.to(torch.bfloat16)
        ctx.save_for_backward(hb, wb)
        ctx.dtypes = (h.dtype, w.dtype)
        ctx.mesh, ctx.model_group = pctx.data_mesh(), model_group
        return layers.mm_f32(hb, wb)

    @staticmethod
    def backward(ctx, grad):
        hb, wb = ctx.saved_tensors
        gb = grad.to(torch.bfloat16)
        dh = None
        if ctx.needs_input_grad[0]:
            dh = layers.mm_f32(gb, wb.T)
            if ctx.model_group is not None:       # w a vocabulary shard
                dh = pctx.all_reduce_f32(dh, ctx.model_group)
            dh = dh.to(ctx.dtypes[0])
        dw = None
        if ctx.needs_input_grad[1]:
            dw = layers.mm_f32(hb.T, gb)
            if ctx.mesh is not None:
                dw = pctx.data_sum(dw, ctx.mesh)
                if pctx.data_index(ctx.mesh):
                    dw.zero_()
            dw = dw.to(torch.bfloat16).to(ctx.dtypes[1])
        return dh, dw, None


def _chunk_nll(hx, w_unembed, yx, ignore_index: int):
    """Summed NLL and weight of one chunk: bf16 logits matmul, fp32 log-sum-exp."""
    logits = _LogitsMatmul.apply(hx, w_unembed)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, 1, yx.clamp(min=0).long()[:, None])[:, 0]
    valid = (yx != ignore_index).float()
    return torch.sum((lse - gold) * valid), torch.sum(valid)


def _chunk_nll_split(hx, w_unembed, yx, ignore_index: int, dh_group):
    """``_chunk_nll`` with ``w_unembed`` this model rank's share of the
    vocabulary: the row max and the sum of exponentials are taken over the
    model ranks, and the label's logit on the rank that holds its row. The
    hidden state's gradient is the ranks' fp32 partials summed over
    ``dh_group``, rounded once; with no group (sequence parallelism) each
    rank's fp32 partial is handed back unrounded, to ``gather_rows``'s
    reduce-scatter."""
    logits = _LogitsMatmul.apply(hx, w_unembed, dh_group)
    m = pctx.model_max(logits.amax(dim=-1))
    lse = m + torch.log(pctx.from_model(torch.exp(logits - m[:, None]).sum(dim=-1)))
    v_loc = w_unembed.shape[1]
    local = yx.long() - pctx.model_index() * v_loc
    own = (local >= 0) & (local < v_loc)
    gold = torch.gather(logits, 1, torch.where(own, local, 0)[:, None])[:, 0]
    gold = pctx.from_model(torch.where(own, gold, 0.0))
    valid = (yx != ignore_index).float()
    return torch.sum((lse - gold) * valid), torch.sum(valid)


def gather_rows(hidden):
    """The whole sequence of the final hidden state from this model rank's
    rows under sequence parallelism (``hidden`` itself otherwise): where the
    layout splits the vocabulary, as the input of split products
    (``layers.split_input``: fp32, the logits matmul's fp32 partials of its
    gradient reduce-scattered back to the rows and rounded once); else
    gathered alike, every rank computing the same loss and keeping its rows
    of the gradient."""
    if not pctx.seq_parallel():
        return hidden
    if pctx.layout().vocab:
        return layers.split_input(hidden)
    return pctx.gather_from_model(hidden, 1)


def chunked_cross_entropy(hidden, w_unembed, labels, *, chunk: int = 2048,
                          ignore_index: int = -1):
    """hidden: (B,S,d); w_unembed: (d,V); labels: (B,S) integers.

    Returns (mean_nll over non-ignored, total_weight), both fp32 0-d tensors.
    Inside ``parallel.ctx.data_parallel`` the weight is the global batch's (the
    data ranks' summed), so the ranks' losses add up to the global mean. Where
    the layout of ``parallel.ctx.model_parallel`` splits the vocabulary
    (``w_unembed`` a ``model`` shard of its columns), the cross entropy is
    vocabulary-parallel (``_chunk_nll_split``); ``_LogitsMatmul``'s roundings
    hold per share. Under sequence parallelism ``hidden`` is the whole
    sequence of ``gather_rows``.
    """
    B, S, d = hidden.shape
    T = B * S
    h = hidden.reshape(T, d)
    y = labels.reshape(T)
    chunk = min(chunk, T)
    n = -(-T // chunk)
    pad = n * chunk - T
    if pad:
        h = F.pad(h, (0, 0, 0, pad))
        y = F.pad(y, (0, pad), value=ignore_index)
    loss_sum = torch.zeros((), dtype=torch.float32, device=hidden.device)
    w_sum = torch.zeros((), dtype=torch.float32, device=hidden.device)
    lay = pctx.layout()
    body = _chunk_nll
    if lay is not None and lay.vocab:
        body = partial(_chunk_nll_split,
                       dh_group=None if pctx.seq_parallel() else pctx.model_group())
    for c0 in range(0, n * chunk, chunk):
        args = (h[c0:c0 + chunk], w_unembed, y[c0:c0 + chunk], ignore_index)
        if torch.is_grad_enabled():
            nll, w = checkpoint(body, *args, use_reentrant=False)
        else:
            nll, w = body(*args)
        loss_sum = loss_sum + nll
        w_sum = w_sum + w
    w_sum = pctx.data_sum(w_sum)
    return loss_sum / torch.clamp(w_sum, min=1.0), w_sum
