"""FA3 trace generation — compatibility front end over the kernel IR.

The hardcoded generator this module used to contain now lives as the
registered ``fa3`` ping-pong :class:`~repro_torch.core.kprog.ir.KernelSpec`
(``repro_torch.core.kprog.fa3``); lowering through the IR is instruction-for-
instruction identical (``tests/test_kprog.py``), so the public helpers here
keep their historical signatures for the benchmarks and tests that import
them.  New code should go through ``repro_torch.core.kprog`` / the kernel
registry instead.
"""
from __future__ import annotations

from types import SimpleNamespace
from typing import Dict, List, Optional, Tuple

from repro_torch.core.engine import CTATrace
from repro_torch.core.isa import TensorMap
from repro_torch.core.kprog.costs import softmax_bubble_cycles  # noqa: F401
from repro_torch.core.kprog.fa3 import (TM_K, TM_O, TM_Q, TM_V,  # noqa: F401
                                  FA3_SPEC, FA3Tiling, make_tmaps)
from repro_torch.core.machine import GPUMachine

__all__ = ["FA3Tiling", "softmax_bubble_cycles", "make_tmaps",
           "fa3_cta_trace", "fa3_kernel_ctas",
           "TM_Q", "TM_K", "TM_V", "TM_O"]


def fa3_cta_trace(cfg: GPUMachine, *, b: int, h_q: int, h_kv: int,
                  q_block: int, S: int, D: int, tiling: FA3Tiling,
                  causal: bool = False, q_base_row: int = 0) -> CTATrace:
    """Trace for one CTA covering q rows [q_block*t_m, ...) of head h_q."""
    w = SimpleNamespace(S=S, D=D, causal=causal)
    return FA3_SPEC.cta(cfg, w, tiling, b=b, h_q=h_q, h_kv=h_kv,
                        q_block=q_block, q_base_row=q_base_row)


def fa3_kernel_ctas(cfg: GPUMachine, *, B: int, H_kv: int, G: int, L: int,
                    S: int, D: int, tiling: FA3Tiling = FA3Tiling(),
                    causal: bool = False,
                    max_ctas: Optional[int] = None
                    ) -> Tuple[List[CTATrace], Dict[int, TensorMap]]:
    """All CTAs of one FA3 launch: B*H_kv*G heads x ceil(L/T_M) q-blocks,
    head-major rasterized.  ``max_ctas=0`` builds zero CTAs (the historic
    falsy-guard accident that treated 0 as "unlimited" is gone)."""
    w = SimpleNamespace(B=B, H_kv=H_kv, G=G, L=L, S=S, D=D, causal=causal)
    return FA3_SPEC.build(cfg, w, tiling=tiling, max_ctas=max_ctas)
