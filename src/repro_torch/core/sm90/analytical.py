"""SimFA-H100 analytical model: the paper's §3 traffic method at the tiling of
the port's own bf16 kernels.

The Hopper counterpart of ``analyze_tpu`` (``src/repro/core/tpu/analytical.py``).
``core/analytical.py`` applies the method to the paper's FA3 (64 x 176 tiles,
one consumer tile a CTA) and FlashDecoding (128-row tiles, reduction CTAs);
this module applies it to the kernels as they are built:

``flash_fwd`` (``csrc/flash_fwd_sm90.cu``)
    ``B * H * ceil(L / 128)`` CTAs of two 64-row consumers, one CTA an SM;
    each walks its K/V tiles of 128 rows up to its last row's diagonal
    (causal) and loads each once (L2 bytes). The query heads of one KV head
    are adjacent in the grid and run side by side, so a K/V tile leaves DRAM
    once for the whole group; where every head's K and V fit the effective
    L2 (Eq. 4, half the nominal), the row blocks that follow find them there
    too, else each row-block pass reads them again (Eq. 6 at the kernel's
    reuse distance).
``flash_decode`` (``csrc/flash_decode_sm90.cu``)
    ``B * Hkv * n_split`` CTAs in clusters of ``n_split``, each a balanced run
    of 16-row tiles; every cache row below ``cache_len`` is read once and the
    partials merge in distributed shared memory, so DRAM sees the cache, q
    and o, nothing else.

Times: the throughput floors (tensor cores, DRAM, L2, softmax) over the whole
card, and the critical path ``t_path``: a CTA's ramp (first tile's round
trip), its tiles at the slowest of its per-tile rates (tensor cores, softmax
behind the other consumer's products, its share of the memory rate, the
ring's refill latency over its depth) and its epilogue, composed over the
waves of resident CTAs. ``latency`` is the largest of them.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

from repro_torch.configs.llama3 import AttnWorkload
from repro_torch.core.kprog.costs import combine_cycles
from repro_torch.core.machine import GPUMachine
from repro_torch.core.sm90.machine import (DEC, FWD, H100_SXM, ctas_per_sm,
                                           mma_sync_cycles, smem_bytes,
                                           softmax_cycles, wgmma_cycles)
from repro_torch.kernels.flash_decode import num_splits_sm90

KERNELS = ("flash_fwd", "flash_decode")
L2_EFFECTIVE_FRACTION = 0.5    # §6.2.2: half the nominal L2 on a partitioned-L2 part
PATH_MARGIN = 1.1              # t_path beyond the largest floor by this: "latency"-bound


@dataclass(frozen=True)
class SM90Report:
    kernel: str
    stages: Optional[int]        # the forward's ring depth (None for the decode)
    n_split: Optional[int]       # the decode's splits (None for the forward)
    flops: float
    dram_bytes_ideal: float      # q, k, v read once, o written once (Eq. 3)
    dram_bytes: float            # at the kernel's reuse (Eq. 6 analogue)
    l2_bytes: float              # what the CTAs load and store (Eq. 2 analogue)
    smem_bytes: int              # one CTA's dynamic shared memory
    ctas: int
    waves: float                 # CTAs over the card's resident slots
    t_compute: float             # seconds: tensor-core cycles over every SM
    t_dram: float
    t_l2: float
    t_softmax: float
    t_path: float                # critical path: ramp, tiles and epilogue over the waves

    @property
    def latency(self) -> float:
        return max(self.t_compute, self.t_dram, self.t_l2, self.t_softmax, self.t_path)

    @property
    def bottleneck(self) -> str:
        floors = {"compute": self.t_compute, "dram": self.t_dram, "l2": self.t_l2,
                  "softmax": self.t_softmax}
        top = max(floors, key=floors.get)
        return "latency" if self.t_path > PATH_MARGIN * floors[top] else top


def _l2_rate(m: GPUMachine) -> float:
    """Bytes an SM-cycle one SM's TMA keeps coming from L2 (core/analytical.py's
    L2 rate, per SM)."""
    return m.tma_max_inflight_lines * m.line_bytes / m.l2_near_latency


def analyze_sm90(w: AttnWorkload, m: GPUMachine = H100_SXM, *, kernel: str = "flash_fwd",
                 stages: Optional[int] = None,
                 n_split: Optional[int] = None) -> SM90Report:
    """The report of one launch of ``kernel`` on workload ``w`` (``w.L == 1`` and
    ``w.S`` the cache length for the decode). ``None`` takes the kernel's
    default: the forward's ring depth for ``w.D``, or ``num_splits_sm90``."""
    if kernel == "flash_fwd":
        return _forward(w, m, FWD.default_stages(w.D) if stages is None else stages)
    if kernel == "flash_decode":
        if n_split is None:
            n_split = num_splits_sm90(w.S, w.B * w.H_kv)
        return _decode(w, m, n_split)
    raise ValueError(f"kernel must be one of {KERNELS}, got {kernel!r}")


def _flops(w: AttnWorkload) -> float:
    f = 4.0 * w.B * (w.H_kv * w.G) * w.L * w.S * w.D      # Eq. (1)
    return f / 2 if w.causal else f


def fwd_tiles(w: AttnWorkload) -> list:
    """K/V tiles each row block of 128 query rows walks, heaviest first (the
    grid's order)."""
    rows = FWD.CONSUMERS * FWD.BM
    n_full = math.ceil(w.S / FWD.BN)
    n_mblk = math.ceil(w.L / rows)
    return [min(n_full, math.ceil((mb + 1) * rows / FWD.BN)) if w.causal else n_full
            for mb in reversed(range(n_mblk))]


def _forward(w: AttnWorkload, m: GPUMachine, stages: int) -> SM90Report:
    P, D, H = w.P, w.D, w.H_kv * w.G
    dp = FWD.template(D)
    tiles = fwd_tiles(w)
    heads = w.B * H
    ctas = len(tiles) * heads
    slots = m.num_sms * ctas_per_sm("flash_fwd", D, stages=stages)

    def kv_rows(n):
        return min(n * FWD.BN, w.S)

    q_o = 2 * P * w.B * H * w.L * D
    kv_once = 2 * P * w.B * w.H_kv * w.S * D
    l2 = q_o + 2 * P * D * heads * sum(kv_rows(n) for n in tiles)
    if kv_once <= m.l2_bytes * L2_EFFECTIVE_FRACTION:
        dram = q_o + kv_once
    else:
        dram = q_o + 2 * P * D * w.B * w.H_kv * sum(kv_rows(n) for n in tiles)

    # one K/V tile of one CTA, in SM-cycles
    qk = wgmma_cycles(FWD.BM, FWD.BN, dp, m)
    pv = wgmma_cycles(FWD.BM, dp, FWD.BN, m)
    sm = softmax_cycles(FWD.BM, FWD.BN, m, d=dp)
    tc_tile = FWD.CONSUMERS * (qk + pv)
    mem_tile = 2 * FWD.BN * D * P / _l2_rate(m)
    trip = m.tma_launch_latency + m.l2_near_latency + m.dram_latency
    per_tile = max(tc_tile, qk + pv + sm, mem_tile, (trip + mem_tile) / stages)
    ramp = trip + m.tma_tmap_setup_latency + mem_tile + qk + sm
    epilogue = pv + math.ceil(FWD.BM * dp / m.fp32_ops_per_cycle) + m.l2_near_latency
    cta = [ramp + n * per_tile + epilogue for n in tiles]
    hz = m.freq_ghz * 1e9
    t_path = max(max(cta), heads * sum(cta) / slots) / hz
    n_tiles = heads * sum(tiles)
    return SM90Report(
        kernel="flash_fwd", stages=stages, n_split=None, flops=_flops(w),
        dram_bytes_ideal=q_o + kv_once, dram_bytes=dram, l2_bytes=l2,
        smem_bytes=smem_bytes("flash_fwd", D, stages), ctas=ctas, waves=ctas / slots,
        t_compute=n_tiles * tc_tile / m.num_sms / hz,
        t_dram=dram / (m.dram_bw_gbps * 1e9),
        t_l2=l2 / (_l2_rate(m) * m.num_sms * hz),
        t_softmax=n_tiles * sm / m.num_sms / hz,
        t_path=t_path)


def _decode(w: AttnWorkload, m: GPUMachine, n_split: int) -> SM90Report:
    P, D, G, clen = w.P, w.D, w.G, w.S
    H = w.H_kv * G
    dp, nb = DEC.template(D), DEC.head_blocks(G)
    tiles = math.ceil(clen / DEC.TN)
    groups = w.B * w.H_kv
    ctas = groups * n_split
    slots = m.num_sms * ctas_per_sm("flash_decode", D, G=G)
    per_sm = math.ceil(min(ctas, slots) / m.num_sms)      # spread over the SMs

    cache = 2 * P * groups * clen * D
    q = o = P * w.B * H * D
    dram = cache + q + o
    l2 = cache + q * n_split + o        # every split reads the group's q

    # one 16-row tile of one CTA, in SM-cycles
    hz = m.freq_ghz * 1e9
    mem_tile = 2 * DEC.TN * D * P * min(ctas, slots) / (m.dram_bw_gbps * 1e9 / hz)
    qk = mma_sync_cycles(DEC.TN, 8 * nb, dp)
    pv = 2 * mma_sync_cycles(dp, 8 * nb, DEC.TN)          # P_hi and P_lo
    sm = DEC.NW * softmax_cycles(DEC.TN, 8 * nb, m, d=dp)  # one warp: a quarter of the lanes
    trip = m.l2_far_latency + m.dram_latency
    per_tile = max(mem_tile, (qk + pv) * per_sm, (qk + sm + pv) / DEC.NW,
                   (trip + mem_tile) / DEC.RING)
    ramp = m.tma_launch_latency + trip + mem_tile
    # the cluster merge: every CTA pushes its partial and row stats into the
    # owners' shared memory (one remote round trip), then merges its columns
    merge = (combine_cycles(m, G, math.ceil(D / n_split), n_split) + m.l2_near_latency
             if n_split > 1 else 0)
    epilogue = math.ceil(DEC.NW * G * D / m.fp32_ops_per_cycle) + merge + m.l2_near_latency
    run = math.ceil(tiles / n_split)
    t_path = math.ceil(ctas / slots) * (ramp + run * per_tile + epilogue) / hz
    n_tiles = groups * tiles
    return SM90Report(
        kernel="flash_decode", stages=None, n_split=n_split, flops=_flops(w),
        dram_bytes_ideal=dram, dram_bytes=dram, l2_bytes=l2,
        smem_bytes=smem_bytes("flash_decode", D), ctas=ctas, waves=ctas / slots,
        t_compute=n_tiles * (qk + pv) / m.num_sms / hz,
        t_dram=dram / (m.dram_bw_gbps * 1e9),
        t_l2=l2 / (_l2_rate(m) * m.num_sms * hz),
        t_softmax=n_tiles * sm / DEC.NW / m.num_sms / hz,
        t_path=t_path)
