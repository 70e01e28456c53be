"""Family-dispatching model facade used by the train, serve and launch layers.

Batch contract (all tensors):
  train:   {"tokens": (B,S_tok), "labels": (B,S_tok), ["embeds"|"frames"]}
  prefill: {"tokens": (B,S_tok), ["embeds"|"frames"]}
  decode:  {"tokens": (B,1)} + cache

Entry points run on the card: ``device`` defaults to ``"cuda"`` and a missing
card raises. The CPU is used only when the caller asks for it.
"""
from __future__ import annotations

from typing import Any, Dict, Union

import torch

from repro_torch.models import encdec, layers, transformer


def resolve_device(device="cuda") -> torch.device:
    """``torch.device`` of ``device``; raises if it names a CUDA device and none is there."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} was asked for but no CUDA device is available; "
            "pass device='cpu' to run the plain PyTorch path on the host")
    return dev


def require_ported(cfg):
    """Raises ``NotImplementedError`` for a family the port has no model of."""
    if cfg.family != "encdec":
        transformer._require_ported(cfg)


def init(cfg, seed: Union[int, torch.Generator] = 0, *, device="cuda", place=None):
    """Seeded fp32 parameters on ``device``. ``seed`` may be a ``torch.Generator``
    that already lives on that device. On ``device="meta"`` the tree holds the
    parameters' shapes and dtypes only (the counterpart of the reference's
    ``jax.eval_shape(lambda: api.init(cfg, key))``): nothing is drawn, so a model
    of any width builds in no memory, and ``seed`` is ignored. ``place`` is
    ``transformer.init_lm``'s (``encdec.init_encdec``'s for whisper)."""
    require_ported(cfg)
    if isinstance(seed, torch.Generator):
        gen = seed
    else:
        dev = resolve_device(device)
        gen = (layers.SHAPE_ONLY if dev.type == "meta"
               else torch.Generator(device=dev).manual_seed(int(seed)))
    if cfg.family == "encdec":
        return encdec.init_encdec(cfg, gen, place)
    return transformer.init_lm(cfg, gen, place)


def cast_params(cfg, params, dtype=None, device=None):
    return transformer.cast_params(cfg, params, dtype, device)


def forward_hidden(cfg, params, batch: Dict[str, Any], *, attn_fn=None,
                   remat: str = "full", moe_impl: str = "einsum", mode=None):
    """Forward to final hidden states. Returns (hidden, aux): aux is the MoE
    load-balance loss summed over the layers (0.0 for the other families)."""
    if cfg.family == "encdec":
        enc_h = encdec.encode(cfg, params, batch["frames"], attn_fn=attn_fn,
                              remat=remat, mode=mode)
        hidden = encdec.decode_train(cfg, params, batch["tokens"], enc_h,
                                     attn_fn=attn_fn, remat=remat, mode=mode)
        return hidden, 0.0
    hidden, aux, _ = transformer.apply_lm(
        cfg, params, batch["tokens"], embeds=batch.get("embeds"),
        attn_fn=attn_fn, remat=remat, moe_impl=moe_impl, mode=mode)
    return hidden, aux


def unembed(cfg, params, hidden):
    if cfg.family == "encdec":
        return encdec.unembed(cfg, params, hidden)
    return transformer.unembed(cfg, params, hidden)


def unembed_table(cfg, params):
    """(d, V) matrix used by the chunked loss."""
    if cfg.family == "encdec" or cfg.tie_embeddings:
        return params["emb"]["table"].T
    return params["unembed"]["w"]


def prefill(cfg, params, batch, *, max_seq=None, remat: str = "full",
            attn_fn=None, mode=None):
    """Returns (hidden, cache). An encdec model ignores ``attn_fn``, as the
    reference does: its prefill takes none."""
    if cfg.family == "encdec":
        return encdec.prefill_encdec(cfg, params, batch["frames"], batch["tokens"],
                                     max_seq=max_seq, remat=remat, mode=mode)
    return transformer.prefill_lm(cfg, params, batch["tokens"],
                                  embeds=batch.get("embeds"),
                                  max_seq=max_seq, remat=remat,
                                  attn_fn=attn_fn, mode=mode)


def decode(cfg, params, cache, tokens, *, mode=None):
    if cfg.family == "encdec":
        return encdec.decode_encdec(cfg, params, cache, tokens, mode=mode)
    return transformer.decode_lm(cfg, params, cache, tokens, mode=mode)


def init_cache(cfg, batch: int, max_seq: int, *, s_enc: int = 0, dtype=torch.bfloat16,
               device="cuda", kv_heads=None):
    """An empty cache on ``device``; an encdec model's cross K/V holds ``s_enc``
    encoder rows (``cfg.frontend_len`` by default). ``kv_heads``: an LM
    family's K/V stacks hold that many kv heads (a rank's block of a cache
    placed over a mesh; ``cfg.num_kv_heads`` by default)."""
    device = resolve_device(device)
    if cfg.family == "encdec":
        return encdec.init_dec_cache(cfg, batch, max_seq, s_enc or cfg.frontend_len,
                                     dtype=dtype, device=device)
    return transformer.init_cache(cfg, batch, max_seq, dtype=dtype, device=device,
                                  kv_heads=kv_heads)
