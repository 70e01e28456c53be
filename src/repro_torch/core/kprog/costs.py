"""Shared CUDA-core cost arithmetic for kernel programs (paper §5.2).

One home for the softmax-bubble formula so the trace generators and the
analytical model (Eq. ramp term) stop re-deriving it by copy-paste.
"""
from __future__ import annotations

import math

from repro_torch.core.machine import GPUMachine

# The paper's reference FA3 tiling (§5.2): the analytical ramp term falls
# back to these when no tiling is given.
DEFAULT_T_M = 64
DEFAULT_T_N = 176


def softmax_bubble_cycles(cfg: GPUMachine, t_m: int, t_n: int, d: int) -> int:
    """§5.2 bubble arithmetic for one (T_M x T_N) tile per consumer WG.

    rowmax + exp + rowsum + fp16-convert + O-rescale; 956 cycles at the
    paper's 64x176xD128 reference point on H800 (the paper quotes ~988
    with a coarser rescale estimate — the golden cycle anchors are built
    on this formula).
    """
    elems = t_m * t_n
    rowmax = math.ceil(elems / cfg.fp32_ops_per_cycle)        # 88 @ 64x176
    expo = math.ceil(elems / cfg.mufu_ops_per_cycle)          # 704
    rowsum = math.ceil(elems / cfg.fp32_ops_per_cycle)        # 88
    cvt = math.ceil(elems / cfg.fp16_ops_per_cycle)           # 44
    rescale = math.ceil(t_m * d / cfg.fp16_ops_per_cycle)     # 32
    return rowmax + expo + rowsum + cvt + rescale             # = 956


def combine_cycles(cfg: GPUMachine, rows: int, d: int, n_parts: int) -> int:
    """Split-KV reduction epilogue: rescale + accumulate ``n_parts`` partial
    O tiles of (rows x d) fp32 plus the final normalization."""
    elems = rows * d
    rescale_acc = n_parts * math.ceil(2 * elems / cfg.fp32_ops_per_cycle)
    lse = n_parts * math.ceil(rows / cfg.mufu_ops_per_cycle)
    norm = math.ceil(elems / cfg.fp32_ops_per_cycle)
    return rescale_acc + lse + norm
