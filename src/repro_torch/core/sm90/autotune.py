"""Model-guided tiling of the port's own bf16 kernels: the forward's ring depth
and the decode's split count, picked the way FA3 picks its tiles, by modeling
the pipeline rather than by hand.

The Hopper counterpart of ``autotune_flash`` / ``KernelPlan``
(``src/repro/core/tpu/autotune.py``), which picks the Pallas kernel's blocks
with SimFA-TPU. Each search is over the settings the kernel takes and nothing
else (a plan is always a setting the wrapper accepts):

``autotune_flash``
    ``stages`` over the ring depths ``csrc/flash_fwd_sm90.cu`` is built with
    for the head-dim template, whose shared memory fits a block's 227 KB.
``autotune_decode``
    ``n_split`` over ``1 .. min(MAX_SPLIT, ceil(cache_len / 16))``: no split
    is empty and a (batch, kv-head)'s splits fit one cluster.

Both short-list by ``analyze_sm90``'s latency, ties to the larger tile (the
deeper ring, the fewer splits), then optionally cycle-simulate the short-list
(``simulate_sm90``) for the final pick.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import List, Optional

from repro_torch.configs.llama3 import AttnWorkload
from repro_torch.core.machine import GPUMachine
from repro_torch.core.sm90.analytical import analyze_sm90
from repro_torch.core.sm90.machine import DEC, FWD, H100_SXM, SMEM_PER_BLOCK, smem_bytes
from repro_torch.core.sm90.tracegen import simulate_sm90


@dataclass
class KernelPlan:
    kernel: str                  # "flash_fwd" or "flash_decode"
    stages: Optional[int]        # the forward's ring depth
    n_split: Optional[int]       # the decode's splits
    predicted_us: float          # analyze_sm90's latency
    bottleneck: str
    smem_bytes: int
    ctas: int
    sim_us: Optional[float] = None


def _plan(w: AttnWorkload, m: GPUMachine, kernel: str, **setting) -> KernelPlan:
    rep = analyze_sm90(w, m, kernel=kernel, **setting)
    return KernelPlan(kernel=kernel, stages=rep.stages, n_split=rep.n_split,
                      predicted_us=rep.latency * 1e6, bottleneck=rep.bottleneck,
                      smem_bytes=rep.smem_bytes, ctas=rep.ctas)


def flash_candidates(w: AttnWorkload, m: GPUMachine = H100_SXM, *,
                     causal: bool) -> List[KernelPlan]:
    """Every built ring depth that fits, best predicted first (ties: deeper)."""
    w = dataclasses.replace(w, causal=causal)
    cands = [_plan(w, m, "flash_fwd", stages=st) for st in FWD.built(w.D)
             if smem_bytes("flash_fwd", w.D, st) <= SMEM_PER_BLOCK]
    cands.sort(key=lambda c: (round(c.predicted_us, 3), -c.stages))
    return cands


def decode_candidates(w: AttnWorkload, m: GPUMachine = H100_SXM) -> List[KernelPlan]:
    """Every split count the kernels take at ``w.S`` cached rows, best
    predicted first (ties: fewer splits)."""
    most = min(DEC.MAX_SPLIT, math.ceil(w.S / DEC.TN))
    cands = [_plan(w, m, "flash_decode", n_split=n) for n in range(1, most + 1)]
    cands.sort(key=lambda c: (round(c.predicted_us, 3), c.n_split))
    return cands


def _pick(w, m, cands: List[KernelPlan], use_sim: bool, top_k: int,
          max_ctas: Optional[int]) -> KernelPlan:
    if not use_sim:
        return cands[0]
    best = None
    for c in cands[:top_k]:
        c.sim_us = simulate_sm90(w, m, kernel=c.kernel, stages=c.stages,
                                 n_split=c.n_split, max_ctas=max_ctas).us
        if best is None or c.sim_us < best.sim_us:
            best = c
    return best


def autotune_flash(w: AttnWorkload, m: GPUMachine = H100_SXM, *, causal: bool = True,
                   use_sim: bool = False, top_k: int = 3,
                   max_ctas: Optional[int] = None) -> KernelPlan:
    """The forward's ring depth for ``w`` (its ``causal`` replaced by ``causal``)."""
    cands = flash_candidates(w, m, causal=causal)
    return _pick(dataclasses.replace(w, causal=causal), m, cands, use_sim, top_k, max_ctas)


def autotune_decode(w: AttnWorkload, m: GPUMachine = H100_SXM, *, use_sim: bool = False,
                    top_k: int = 3, max_ctas: Optional[int] = None) -> KernelPlan:
    """The decode's split count for one token against ``w.S`` cached rows."""
    return _pick(w, m, decode_candidates(w, m), use_sim, top_k, max_ctas)
