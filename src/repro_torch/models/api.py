"""Family-dispatching model facade used by the serve and launch layers.

Batch contract (all tensors):
  prefill: {"tokens": (B,S_tok), ["embeds"]}
  decode:  {"tokens": (B,1)} + cache

Entry points run on the card: ``device`` defaults to ``"cuda"`` and a missing
card raises. The CPU is used only when the caller asks for it.
"""
from __future__ import annotations

from typing import Any, Dict, Union

import torch

from repro_torch.models import transformer


def resolve_device(device="cuda") -> torch.device:
    """``torch.device`` of ``device``; raises if it names a CUDA device and none is there."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} was asked for but no CUDA device is available; "
            "pass device='cpu' to run the plain PyTorch path on the host")
    return dev


def _require_lm(cfg):
    if cfg.family == "encdec":
        raise NotImplementedError(
            f"model family 'encdec' ({cfg.name}) is not ported to repro_torch yet")


def init(cfg, seed: Union[int, torch.Generator] = 0, *, device="cuda"):
    """Seeded fp32 parameters on ``device``. ``seed`` may be a ``torch.Generator``
    that already lives on that device."""
    _require_lm(cfg)
    if isinstance(seed, torch.Generator):
        gen = seed
    else:
        gen = torch.Generator(device=resolve_device(device)).manual_seed(int(seed))
    return transformer.init_lm(cfg, gen)


def cast_params(cfg, params, dtype=None, device=None):
    return transformer.cast_params(cfg, params, dtype, device)


def forward_hidden(cfg, params, batch: Dict[str, Any], *, attn_fn=None,
                   remat: str = "full", mode=None):
    """Forward to final hidden states. Returns (hidden, aux)."""
    _require_lm(cfg)
    hidden, aux, _ = transformer.apply_lm(
        cfg, params, batch["tokens"], embeds=batch.get("embeds"),
        attn_fn=attn_fn, remat=remat, mode=mode)
    return hidden, aux


def unembed(cfg, params, hidden):
    _require_lm(cfg)
    return transformer.unembed(cfg, params, hidden)


def prefill(cfg, params, batch, *, max_seq=None, remat: str = "full",
            attn_fn=None, mode=None):
    _require_lm(cfg)
    return transformer.prefill_lm(cfg, params, batch["tokens"],
                                  embeds=batch.get("embeds"),
                                  max_seq=max_seq, remat=remat,
                                  attn_fn=attn_fn, mode=mode)


def decode(cfg, params, cache, tokens, *, mode=None):
    _require_lm(cfg)
    return transformer.decode_lm(cfg, params, cache, tokens, mode=mode)


def init_cache(cfg, batch: int, max_seq: int, *, dtype=torch.bfloat16,
               device="cuda"):
    _require_lm(cfg)
    return transformer.init_cache(cfg, batch, max_seq, dtype=dtype,
                                  device=resolve_device(device))
