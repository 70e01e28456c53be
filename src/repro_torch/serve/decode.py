"""Serve steps: prefill and single-token decode, greedy-sampled.

``make_serve_step`` returns the decode step the engine runs: one new token per
sequence against a resident KV cache.
"""
from __future__ import annotations

from functools import partial

import torch

from repro_torch.models import api


def make_prefill_step(cfg, *, max_seq: int, remat: str = "full",
                      attn_chunk: int = 512, cast_params: str = "none",
                      attn_pv_bf16: bool = False, mode=None):
    @torch.no_grad()
    def prefill_step(params, batch):
        if cast_params != "none":
            params = api.cast_params(cfg, params, cast_params)
        attn_fn = None
        if attn_chunk != 512 or attn_pv_bf16:
            from repro_torch.models.attention import flash_ref
            attn_fn = partial(flash_ref, chunk=attn_chunk, pv_bf16=attn_pv_bf16)
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
