"""Serve steps: prefill and single-token decode, greedy-sampled.

``make_serve_step`` returns the decode step the engine runs: one new token per
sequence against a resident KV cache.
"""
from __future__ import annotations

import torch

from repro_torch.models import api
from repro_torch.models.attention import knob_attention
from repro_torch.models.layers import to_dtype


def make_prefill_step(cfg, *, max_seq: int, remat: str = "full",
                      attn_chunk: int = 512, cast_params: str = "none",
                      attn_pv_bf16: bool = False, mode=None):
    @torch.no_grad()
    def prefill_step(params, batch):
        if cast_params != "none":
            params = api.cast_params(cfg, params, cast_params)
        attn_fn = knob_attention(attn_chunk, attn_pv_bf16, device=batch["tokens"].device,
                                 dtype=to_dtype(cfg.compute_dtype), mode=mode)
        hidden, cache = api.prefill(cfg, params, batch, max_seq=max_seq,
                                    remat=remat, attn_fn=attn_fn, mode=mode)
        logits = api.unembed(cfg, params, hidden[:, -1:])
        next_tok = torch.argmax(logits, dim=-1).to(torch.int32)
        return next_tok, cache
    return prefill_step


def make_serve_step(cfg, *, mode=None):
    @torch.no_grad()
    def serve_step(params, cache, tokens):
        """tokens: (B, 1) -> (next_token (B,1), cache); the cache is updated in place."""
        logits, cache = api.decode(cfg, params, cache, tokens, mode=mode)
        next_tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
        return next_tok, cache
    return serve_step
