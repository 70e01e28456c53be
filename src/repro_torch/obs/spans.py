"""Named host ranges of the port's layers, on the profiler's clock.

``span(name)`` marks one layer's stretch of host time. While no
``torch.profiler`` session is active it returns one shared no-op context:
one flag read, no allocation and no clock read. While a session is active it
opens ``torch.profiler.record_function("repro." + name)``, a host range in
the same session as the card's kernels, on the same clock, linked by the
profiler to the kernels launched inside it. Nothing else is recorded and
nothing is exported: the profiler's own trace holds the ranges.

``serving_span(name)`` is ``span(name)`` where grad mode is off, and the
no-op where it is on. The model's and the kernel seam's spans use it, so
that no range opens inside an autograd backward node or a checkpointed
region's recompute (a range's card-side copy there would be counted with
the backward's kernels).

The spans, by layer:

- engine (``serve/engine.py``): ``engine.tick`` (``ServeEngine.step``),
  ``engine.prefill`` (an admission, ``_prefill_slot``), ``engine.wait``
  (the readback of a decode step's tokens), ``engine.emit`` (the tokens'
  bookkeeping after it);
- serve steps (``serve/decode.py``): ``serve.decode`` (``make_serve_step``'s
  step, the sharded path too);
- model (``models/transformer.py``, grad off): ``model.attn``, ``model.mlp``;
- kernel seam (``kernels/ops.py``, grad off): ``kernels.flash_decode``,
  ``kernels.flash_attention``;
- trainer (``train/trainer.py``): ``train.step``, ``train.grads`` (a
  microbatch's forward and backward), ``train.optimizer``.
"""
from __future__ import annotations

import contextlib

import torch

PREFIX = "repro."
NOOP = contextlib.nullcontext()
_profiling = torch._C._autograd._profiler_enabled


def span(name: str):
    """The host range ``repro.<name>`` while a profiler session is active,
    else the shared no-op."""
    if not _profiling():
        return NOOP
    return torch.profiler.record_function(PREFIX + name)


def serving_span(name: str):
    """``span(name)`` with grad mode off; the shared no-op with it on."""
    return NOOP if torch.is_grad_enabled() else span(name)
