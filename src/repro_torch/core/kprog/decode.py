"""Split-KV FlashDecoding decode attention (the serving workload).

Decode-shaped launch (arXiv:2402.13499's decode taxonomy): one new token
per sequence (``w.L == 1``) against a resident KV cache of length ``w.S``.
A plain FA3 launch degenerates to ``B * H_kv * G`` skinny CTAs — far too
few to fill the machine — so the KV axis is split across CTAs instead:

  * **split CTAs** — one per (batch, kv-head, split): a TMA producer
    streams the split's K/V chunk, a single consumer runs T_M = G row
    GEMMs (the G grouped query heads of one KV head stacked as MMA rows —
    each is a 1-row q block) and stores a partial fp32 O tile + LSE to a
    scratch buffer;
  * **reduction CTAs** — one per (batch, kv-head): load the ``n_split``
    partials, rescale/accumulate them on CUDA cores, store the final O.

The engine has no inter-CTA barrier; reduction CTAs are launched after all
split CTAs, which under head-major rasterization puts each reduction a full
wave behind its producers (exact cross-CTA ordering is a known
approximation, documented in docs/kernels.md).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict

from repro_torch.core.engine import CTATrace
from repro_torch.core.isa import TensorMap
from repro_torch.core.kprog import registry
from repro_torch.core.kprog.costs import combine_cycles, softmax_bubble_cycles
from repro_torch.core.kprog.ir import CTABuilder, KernelSpec, Ring, Role
from repro_torch.core.machine import GPUMachine

TM_Q, TM_K, TM_V, TM_O, TM_PART = 0, 1, 2, 3, 4
PART_P = 4        # partials are fp32


@dataclass(frozen=True)
class SplitKVTiling:
    t_n: int = 128         # kv rows per tile
    stages: int = 2        # ring-buffer stages for K and V each
    n_split: int = 4       # KV splits (split CTAs per (batch, kv head))
    precision: int = 2     # fp16 activations


class SplitKVDecode(KernelSpec):
    """FlashDecoding: KV split across CTAs + reduction epilogue."""

    name = "splitkv_decode"
    roles = (Role("producer"), Role("consumer"), Role("reducer"))
    scheduling = "split-kv"

    def default_tiling(self) -> SplitKVTiling:
        return SplitKVTiling()

    def probe_workload(self):
        """Decode-shaped probe: one query token, cache long enough that
        every split streams 3 tiles (> stages, so the ring wraps)."""
        from repro_torch.configs.llama3 import AttnWorkload
        return AttnWorkload(name=f"{self.name}-probe", B=1, L=1, S=1536,
                            H_kv=1, G=2, D=64)

    # -- geometry --------------------------------------------------------
    def grid(self, w, tiling: SplitKVTiling):
        for b in range(w.B):
            for hkv in range(w.H_kv):
                for s in range(tiling.n_split):
                    yield dict(b=b, h_kv=hkv, split=s)
        for b in range(w.B):
            for hkv in range(w.H_kv):
                yield dict(b=b, h_kv=hkv, split=-1)      # reduction CTA

    def total_ctas(self, w, tiling: SplitKVTiling = None) -> int:
        tiling = tiling if tiling is not None else self.default_tiling()
        return w.B * w.H_kv * (tiling.n_split + 1)

    def tmaps(self, w, tiling: SplitKVTiling) -> Dict[int, TensorMap]:
        """Q/O are (B, 1, H_q*D) single-token tensors; partials live in a
        (B, n_split, H_kv*G*D) fp32 scratch past the O tensor."""
        P, D, G = tiling.precision, w.D, w.G
        H_q = w.H_kv * w.G
        sz_q = w.B * H_q * D * P
        sz_kv = w.B * w.S * w.H_kv * D * P
        base_o = sz_q + 2 * sz_kv
        base_part = base_o + sz_q
        row = w.H_kv * G * D
        return {
            TM_Q: TensorMap(TM_Q, 0, (w.B, 1, H_q * D),
                            (H_q * D * P, H_q * D * P, P),
                            (1, 1, G * D), P),
            TM_K: TensorMap(TM_K, sz_q, (w.B, w.S, w.H_kv * D),
                            (w.S * w.H_kv * D * P, w.H_kv * D * P, P),
                            (1, tiling.t_n, D), P),
            TM_V: TensorMap(TM_V, sz_q + sz_kv, (w.B, w.S, w.H_kv * D),
                            (w.S * w.H_kv * D * P, w.H_kv * D * P, P),
                            (1, tiling.t_n, D), P),
            TM_O: TensorMap(TM_O, base_o, (w.B, 1, H_q * D),
                            (H_q * D * P, H_q * D * P, P),
                            (1, 1, G * D), P),
            TM_PART: TensorMap(TM_PART, base_part,
                               (w.B, tiling.n_split, row),
                               (tiling.n_split * row * PART_P,
                                row * PART_P, PART_P),
                               (1, 1, G * D), PART_P),
        }

    # -- role programs ---------------------------------------------------
    def cta(self, cfg: GPUMachine, w, tiling: SplitKVTiling, *, b: int,
            h_kv: int, split: int) -> CTATrace:
        if split < 0:
            return self._reduction_cta(cfg, w, tiling, b=b, h_kv=h_kv)
        return self._split_cta(cfg, w, tiling, b=b, h_kv=h_kv, split=split)

    def _split_cta(self, cfg, w, tiling, *, b, h_kv, split) -> CTATrace:
        t_n, D, G = tiling.t_n, w.D, w.G
        chunk = math.ceil(w.S / tiling.n_split)
        lo = split * chunk
        hi = min(w.S, lo + chunk)
        n_tiles = max(0, math.ceil((hi - lo) / t_n))
        bubbles = softmax_bubble_cycles(cfg, G, t_n, D)
        n_qk = D // 16
        n_pv = math.ceil(t_n / 16)

        cb = CTABuilder(rings=(Ring("K", tiling.stages),
                               Ring("V", tiling.stages)),
                        n_consumers=1, name=f"b{b}h{h_kv}s{split}")

        p = cb.wg("producer")
        p.load(TM_Q, (b, 0, h_kv * G * D), token="q_ready", tag="Q")
        for j in range(n_tiles):
            row = lo + j * t_n
            p.acquire("K", j)
            p.load(TM_K, (b, row, h_kv * D), ring="K", slot=j, tag=f"K{j}")
            p.acquire("V", j)
            p.load(TM_V, (b, row, h_kv * D), ring="V", slot=j, tag=f"V{j}")

        t = cb.wg("consumer")
        t.wait_token("q_ready")
        for j in range(n_tiles):
            t.wait_tile("K", j)
            # wait=0: a single consumer has no opposite-phase warpgroup to
            # pipeline behind (same rule as fa3_cooperative) — the softmax
            # consumes the scores this QK just produced
            t.gemm(m=G, n=t_n, steps=n_qk, tag=f"QK{j}", wait=0)
            t.release("K", j)
            t.bubbles(bubbles)
            t.wait_tile("V", j)
            t.gemm(m=G, n=D, steps=n_pv, tag=f"PV{j}", wait=0)
            t.release("V", j)
        t.store(TM_PART, (b, split, h_kv * G * D), tag="Opart")

        return cb.finish()

    def _reduction_cta(self, cfg, w, tiling, *, b, h_kv) -> CTATrace:
        G, D = w.G, w.D
        cb = CTABuilder(n_consumers=1, name=f"b{b}h{h_kv}red")
        r = cb.wg("reducer")
        for s in range(tiling.n_split):
            r.load(TM_PART, (b, s, h_kv * G * D), token="parts",
                   tag=f"P{s}")
        for _ in range(tiling.n_split):
            r.wait_token("parts")
        r.bubbles(combine_cycles(cfg, G, D, tiling.n_split))
        r.store(TM_O, (b, 0, h_kv * G * D), tag="O")
        return cb.finish()

    # -- analytical hooks ------------------------------------------------
    def l2_traffic(self, w, t_m: int = 64, tiling=None) -> float:
        """Q re-read per split CTA + KV streamed once + partial write/read
        + final O write (``t_m`` is not a decode knob; the split count
        comes from the tiling)."""
        tl = tiling if tiling is not None else self.default_tiling()
        gd = w.H_kv * w.G * w.D
        q = w.P * w.B * tl.n_split * gd
        kv = 2 * w.P * w.B * w.H_kv * w.S * w.D
        parts = 2 * PART_P * w.B * tl.n_split * gd
        o = w.P * w.B * gd
        return q + kv + parts + o

    def dram_ideal(self, w) -> float:
        # Q once (L2 serves the split re-reads), KV once, O once
        return w.P * w.B * w.D * (2 * w.H_kv * w.G + 2 * w.H_kv * w.S)

    def ramp_bubble_cycles(self, cfg, w, t_m: int, t_n: int) -> int:
        # decode's compute block is G rows (one per grouped q head), not
        # the prefill T_M tile
        return softmax_bubble_cycles(cfg, w.G, t_n, w.D)

    def dram_real(self, w, t_m: int, n_sm: int, o_limit: int,
                  tiling=None) -> float:
        """Single pass over the cache — but every partial-store line is a
        write-allocate miss that fetches from DRAM before dirtying."""
        tl = tiling if tiling is not None else self.default_tiling()
        parts = PART_P * w.B * tl.n_split * w.H_kv * w.G * w.D
        o_fill = w.P * w.B * w.H_kv * w.G * w.D
        return self.dram_ideal(w) + parts + o_fill


SPLITKV_DECODE_SPEC = registry.register(SplitKVDecode())
