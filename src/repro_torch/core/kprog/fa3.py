"""FlashAttention-3 kernel specs (paper §5.1-§5.2, Table 4).

Two scheduling variants of the 1-producer / 2-consumer warp-specialized
kernel (Hopper dissection taxonomy, arXiv:2402.13499):

  * ``fa3`` — **ping-pong**: the consumers pass MMA/softmax tokens through
    two named barriers so one warpgroup's softmax hides behind the other's
    WGMMAs.  This spec lowers instruction-for-instruction to the pre-IR
    hardcoded generator (golden anchor: the reference full-fidelity launch
    stays at 73614 cycles).
  * ``fa3_cooperative`` — same per-warpgroup work, but the consumers run
    in lockstep with no token pass and drain each QK group before its
    softmax; both bubbles land concurrently, so the tensor core idles
    through them (the bubble-exposure ablation).

Having no H800 to instrument, the "runtime log" phase is replaced by a
schedule-exact generator that walks the same loop structure as the FA3
kernel — the translation rules from events to instructions are the paper's.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict

from repro_torch.core import analytical
from repro_torch.core.engine import CTATrace
from repro_torch.core.isa import TensorMap
from repro_torch.core.kprog import registry
from repro_torch.core.kprog.costs import (DEFAULT_T_M, DEFAULT_T_N,
                                    softmax_bubble_cycles)
from repro_torch.core.kprog.ir import CTABuilder, KernelSpec, Ring, Role
from repro_torch.core.machine import GPUMachine

# tensor-map ids
TM_Q, TM_K, TM_V, TM_O = 0, 1, 2, 3


@dataclass(frozen=True)
class FA3Tiling:
    t_m: int = DEFAULT_T_M     # query rows per CTA (per paper §5.2)
    t_n: int = DEFAULT_T_N     # kv tile rows
    stages: int = 2            # ring-buffer stages for K and V each
    precision: int = 2         # fp16


def make_tmaps(B: int, L: int, S: int, H_q: int, H_kv: int, D: int,
               tiling: FA3Tiling, base: int = 0) -> Dict[int, TensorMap]:
    """Layouts follow the FA3 kernel's (B, S, H, D) tensors: consecutive
    sequence rows of one head are H*D*P bytes apart — the 2048-byte strides
    that concentrate requests on L2 slices under a naive low-bit hash
    (paper §5.4). A head's tile is addressed via an inner-dim origin offset
    of h*D elements."""
    P = tiling.precision
    sz_q = B * L * H_q * D * P
    sz_kv = B * S * H_kv * D * P
    return {
        TM_Q: TensorMap(TM_Q, base, (B, L, H_q * D),
                        (L * H_q * D * P, H_q * D * P, P),
                        (1, tiling.t_m, D), P),
        TM_K: TensorMap(TM_K, base + sz_q, (B, S, H_kv * D),
                        (S * H_kv * D * P, H_kv * D * P, P),
                        (1, tiling.t_n, D), P),
        TM_V: TensorMap(TM_V, base + sz_q + sz_kv, (B, S, H_kv * D),
                        (S * H_kv * D * P, H_kv * D * P, P),
                        (1, tiling.t_n, D), P),
        TM_O: TensorMap(TM_O, base + sz_q + 2 * sz_kv, (B, L, H_q * D),
                        (L * H_q * D * P, H_q * D * P, P),
                        (1, tiling.t_m, D), P),
    }


def _n_kv_tiles(w, tiling: FA3Tiling, q_block: int,
                q_base_row: int = 0) -> int:
    n_tiles = math.ceil(w.S / tiling.t_n)
    if w.causal:
        last_row = q_base_row + q_block * tiling.t_m + tiling.t_m - 1
        n_tiles = min(n_tiles, math.ceil((last_row + 1) / tiling.t_n))
    return n_tiles


class FA3PingPong(KernelSpec):
    """FA3 with ping-pong consumer scheduling (the paper's kernel)."""

    name = "fa3"
    roles = (Role("producer"), Role("consumer", 2))
    scheduling = "ping-pong"

    def default_tiling(self) -> FA3Tiling:
        return FA3Tiling()

    # -- geometry --------------------------------------------------------
    def grid(self, w, tiling: FA3Tiling):
        """Head-major rasterization: one wave works on as few distinct KV
        heads as possible — the reuse structure behind Eq. (5)/(6)."""
        n_q = math.ceil(w.L / tiling.t_m)
        for b in range(w.B):
            for hkv in range(w.H_kv):
                for g in range(w.G):
                    hq = hkv * w.G + g
                    for qb in range(n_q):
                        yield dict(b=b, h_q=hq, h_kv=hkv, q_block=qb)

    def tmaps(self, w, tiling: FA3Tiling) -> Dict[int, TensorMap]:
        return make_tmaps(w.B, w.L, w.S, w.H_kv * w.G, w.H_kv, w.D, tiling)

    def total_ctas(self, w, tiling: FA3Tiling = None) -> int:
        tiling = tiling if tiling is not None else self.default_tiling()
        return w.B * w.H_kv * w.G * math.ceil(w.L / tiling.t_m)

    # -- role programs ---------------------------------------------------
    def cta(self, cfg: GPUMachine, w, tiling: FA3Tiling, *, b: int,
            h_q: int, h_kv: int, q_block: int,
            q_base_row: int = 0) -> CTATrace:
        t_m, t_n, D = tiling.t_m, tiling.t_n, w.D
        n_tiles = _n_kv_tiles(w, tiling, q_block, q_base_row)
        bubbles = softmax_bubble_cycles(cfg, t_m, t_n, D)
        n_qk = D // 16                      # 8 WGMMAs per QK GEMM (§5.2)
        n_pv = math.ceil(t_n / 16)          # 11 WGMMAs per PV GEMM

        cb = CTABuilder(rings=(Ring("K", tiling.stages),
                               Ring("V", tiling.stages)),
                        n_consumers=2, name=f"b{b}h{h_q}q{q_block}")

        # producer: Q first, then stream K/V tiles through the ring buffer
        p = cb.wg("producer")
        p.load(TM_Q, (b, q_block * t_m, h_q * D), token="q_ready", tag="Q")
        for j in range(n_tiles):
            p.acquire("K", j)
            p.load(TM_K, (b, j * t_n, h_kv * D), ring="K", slot=j,
                   tag=f"K{j}")
            p.acquire("V", j)
            p.load(TM_V, (b, j * t_n, h_kv * D), ring="V", slot=j,
                   tag=f"V{j}")

        # consumers: ping-pong via two named barriers ("mma" token release,
        # "softmax" token release); await_arrivals uses absolute thresholds
        for c in (0, 1):
            t = cb.wg(f"consumer{c}")
            t.wait_token("q_ready")
            for j in range(n_tiles):
                t.wait_tile("K", j)
                if c == 0:
                    # consumer0 announces it's entering MMA; consumer1 waits
                    t.arrive("mma")
                else:
                    t.await_arrivals("mma", j + 1)
                t.gemm(m=t_m, n=t_n, steps=n_qk, tag=f"QK{j}", wait=1)
                t.release("K", j)                 # K done (§5.2)
                if c == 0:
                    t.await_arrivals("softmax", j + 1)
                else:
                    t.arrive("softmax")
                t.bubbles(bubbles)                # softmax block
                t.wait_tile("V", j)
                t.gemm(m=t_m, n=D, steps=n_pv, tag=f"PV{j}", wait=0)
                t.release("V", j)                 # V done
            t.store(TM_O, (b, q_block * t_m, h_q * D), tag="O")

        return cb.finish()

    # -- analytical hooks: the paper's FA3 equations ---------------------
    def l2_traffic(self, w, t_m: int = 64, tiling=None) -> float:
        return analytical.l2_traffic(w, t_m)

    def dram_ideal(self, w) -> float:
        return analytical.dram_ideal(w)

    def dram_real(self, w, t_m: int, n_sm: int, o_limit: int,
                  tiling=None) -> float:
        return analytical.dram_real(w, t_m, n_sm, o_limit)


class FA3Cooperative(FA3PingPong):
    """FA3 with cooperative consumer scheduling: the two consumer
    warpgroups share each tile in lockstep — same producer, same ring
    buffer, same per-warpgroup instruction work as ping-pong (the seed's
    convention: each consumer warpgroup runs the full tile loop) — but
    **no named-barrier token pass**, and the QK group drains fully
    (``wait=0``) before the softmax: without an opposite-phase warpgroup
    to pipeline behind, the softmax consumes the scores its own QK just
    produced.  Both consumers hit softmax together, so the bubbles expose
    on the tensor-core timeline (arXiv:2402.13499's
    cooperative-vs-ping-pong comparison)."""

    name = "fa3_cooperative"
    scheduling = "cooperative"

    def cta(self, cfg: GPUMachine, w, tiling: FA3Tiling, *, b: int,
            h_q: int, h_kv: int, q_block: int,
            q_base_row: int = 0) -> CTATrace:
        t_m, t_n, D = tiling.t_m, tiling.t_n, w.D
        n_tiles = _n_kv_tiles(w, tiling, q_block, q_base_row)
        bubbles = softmax_bubble_cycles(cfg, t_m, t_n, D)
        n_qk = D // 16
        n_pv = math.ceil(t_n / 16)

        cb = CTABuilder(rings=(Ring("K", tiling.stages),
                               Ring("V", tiling.stages)),
                        n_consumers=2, name=f"b{b}h{h_q}q{q_block}")

        p = cb.wg("producer")
        p.load(TM_Q, (b, q_block * t_m, h_q * D), token="q_ready", tag="Q")
        for j in range(n_tiles):
            p.acquire("K", j)
            p.load(TM_K, (b, j * t_n, h_kv * D), ring="K", slot=j,
                   tag=f"K{j}")
            p.acquire("V", j)
            p.load(TM_V, (b, j * t_n, h_kv * D), ring="V", slot=j,
                   tag=f"V{j}")

        for c in (0, 1):
            t = cb.wg(f"consumer{c}")
            t.wait_token("q_ready")
            for j in range(n_tiles):
                t.wait_tile("K", j)
                # wait=0: the §5.2 WAIT_WG_1 trick (leave the QK group in
                # flight under the softmax) is what the ping-pong barrier
                # schedule buys; cooperative consumers drain first
                t.gemm(m=t_m, n=t_n, steps=n_qk, tag=f"QK{j}", wait=0)
                t.release("K", j)
                t.bubbles(bubbles)
                t.wait_tile("V", j)
                t.gemm(m=t_m, n=D, steps=n_pv, tag=f"PV{j}", wait=0)
                t.release("V", j)
            t.store(TM_O, (b, q_block * t_m, h_q * D), tag="O")

        return cb.finish()


FA3_SPEC = registry.register(FA3PingPong())
FA3_COOPERATIVE_SPEC = registry.register(FA3Cooperative())
