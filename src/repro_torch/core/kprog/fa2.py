"""FA2-style non-specialized attention kernel (the ablation baseline).

No warp specialization (Hopper dissection taxonomy, arXiv:2402.13499):
each of the CTA's two warpgroups issues its **own** K/V tile loads from
inside the compute instruction stream — there is no TMA producer to run
ahead, no shared smem ring between warpgroups (each worker streams through
a private ring, doubling tile traffic), no named-barrier token pass, and
every GEMM drains fully (``wait=0``) before the softmax that consumes it.
Prefetch depth is exactly the ring's stage count: the load for tile
``j + stages`` issues only after tile ``j``'s compute retired its slot.
"""
from __future__ import annotations

import math

from repro_torch.core.engine import CTATrace
from repro_torch.core.kprog import registry
from repro_torch.core.kprog.costs import softmax_bubble_cycles
from repro_torch.core.kprog.fa3 import (TM_K, TM_O, TM_Q, TM_V, FA3PingPong,
                                  FA3Tiling, _n_kv_tiles)
from repro_torch.core.kprog.ir import CTABuilder, Ring, Role
from repro_torch.core.machine import GPUMachine

N_WORKERS = 2      # matches FA3's two consumer warpgroups (equal tiling)


class FA2NonSpecialized(FA3PingPong):
    """Two self-loading worker warpgroups per CTA, no producer.

    Geometry (grid / tmaps / total_ctas) and the DRAM hooks are inherited
    from the FA3 spec — the ablation compares equal launch shapes — only
    the role programs and the L2 hook (doubled tile streams) differ."""

    name = "fa2"
    roles = (Role("worker", N_WORKERS),)
    scheduling = "non-specialized"
    # acquires in flight before the first release; None = the ring's stage
    # count (the deepest legal value — anything larger over-subscribes the
    # ring and is rejected by the kprog verifier)
    prefetch_depth: "int | None" = None

    # -- role programs ---------------------------------------------------
    def cta(self, cfg: GPUMachine, w, tiling: FA3Tiling, *, b: int,
            h_q: int, h_kv: int, q_block: int,
            q_base_row: int = 0) -> CTATrace:
        t_m, t_n, D = tiling.t_m, tiling.t_n, w.D
        stages = tiling.stages
        n_tiles = _n_kv_tiles(w, tiling, q_block, q_base_row)
        bubbles = softmax_bubble_cycles(cfg, t_m, t_n, D)
        n_qk = D // 16
        n_pv = math.ceil(t_n / 16)
        depth = self.prefetch_depth if self.prefetch_depth is not None \
            else stages

        # private K/V rings per worker: no cross-warpgroup smem sharing
        rings = []
        for c in range(N_WORKERS):
            rings += [Ring(f"K{c}", stages), Ring(f"V{c}", stages)]
        cb = CTABuilder(rings=rings, n_consumers=1,
                        name=f"b{b}h{h_q}q{q_block}")

        for c in range(N_WORKERS):
            t = cb.wg(f"worker{c}")
            kr, vr = f"K{c}", f"V{c}"

            def load_tile(j: int) -> None:
                t.acquire(kr, j)
                t.load(TM_K, (b, j * t_n, h_kv * D), ring=kr, slot=j,
                       tag=f"K{j}")
                t.acquire(vr, j)
                t.load(TM_V, (b, j * t_n, h_kv * D), ring=vr, slot=j,
                       tag=f"V{j}")

            # prologue: own Q load + fill the ring
            t.load(TM_Q, (b, q_block * t_m, h_q * D), token=f"q{c}", tag="Q")
            for j in range(min(depth, n_tiles)):
                load_tile(j)
            t.wait_token(f"q{c}")
            for j in range(n_tiles):
                t.wait_tile(kr, j)
                t.gemm(m=t_m, n=t_n, steps=n_qk, tag=f"QK{j}", wait=0)
                t.release(kr, j)
                t.bubbles(bubbles)
                t.wait_tile(vr, j)
                t.gemm(m=t_m, n=D, steps=n_pv, tag=f"PV{j}", wait=0)
                t.release(vr, j)
                if j + depth < n_tiles:       # in-stream prefetch
                    load_tile(j + depth)
            t.store(TM_O, (b, q_block * t_m, h_q * D), tag="O")

        return cb.finish()

    # -- analytical hooks ------------------------------------------------
    def l2_traffic(self, w, t_m: int = 64, tiling=None) -> float:
        """Eq. (2) with per-worker tile streams: each CTA reads Q twice and
        every K/V tile twice (no producer smem sharing)."""
        s_eff = w.S / 2 if w.causal else w.S
        return w.P * w.B * (w.H_kv * w.G) * w.D * (
            3 * w.L + math.ceil(w.L / t_m) * 2 * s_eff * N_WORKERS)
    # DRAM hooks inherited from FA3PingPong: the L2/LRC absorbs the
    # intra-CTA duplicate streams, so Eq. 3/6 apply unchanged


FA2_SPEC = registry.register(FA2NonSpecialized())
