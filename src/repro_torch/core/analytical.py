"""SimFA-python: the paper's analytical traffic/performance model (§3).

Implements Eq. (1)-(12) exactly, including the two-regime DRAM model with
the concurrency-aware wave factor (Eq. 5-6) that ideal-cache models miss.
Notation follows Table 1 (B, L, S, H_kv, G, D, T_M, P, N_SM, O_limit).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Union

from repro_torch.configs.llama3 import AttnWorkload
from repro_torch.core.kprog import registry as kernel_registry
from repro_torch.core.kprog.costs import DEFAULT_T_N
from repro_torch.core.machine import GPUMachine


@dataclass(frozen=True)
class TrafficReport:
    flops: float                 # Eq. (1)
    l2_bytes: float              # Eq. (2)
    dram_ideal_bytes: float      # Eq. (3)
    dram_real_bytes: float       # Eq. (6)
    ideal_regime: bool           # Eq. (4)
    waves_per_group: int         # Eq. (5)
    traffic_ratio: float         # Eq. (7)
    intensity_l2: float          # Eq. (11)
    intensity_approx: float      # Eq. (12)
    # time estimates (seconds) for the roofline composition
    t_compute: float = 0.0
    t_l2: float = 0.0
    t_dram: float = 0.0
    # pipeline fill/drain: the first tile must traverse TMA setup + memory
    # latency + two MMA/softmax stages before steady state; dominates small
    # single-wave launches where throughput rooflines are optimistic
    t_ramp: float = 0.0

    @property
    def dram_bytes(self) -> float:
        return self.dram_ideal_bytes if self.ideal_regime else self.dram_real_bytes

    @property
    def latency(self) -> float:
        return max(self.t_compute, self.t_l2, self.t_dram) + self.t_ramp

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "l2": self.t_l2, "dram": self.t_dram}
        return max(terms, key=terms.get)


def total_flops(w: AttnWorkload) -> float:
    """Eq. (1): 4 * B * (H_kv*G) * L * S * D (non-causal)."""
    f = 4.0 * w.B * (w.H_kv * w.G) * w.L * w.S * w.D
    return f / 2 if w.causal else f


def l2_traffic(w: AttnWorkload, t_m: int) -> float:
    """Eq. (2): P*B*(H_kv*G)*D*(2L + ceil(L/T_M)*2S)."""
    s_eff = w.S / 2 if w.causal else w.S
    return w.P * w.B * (w.H_kv * w.G) * w.D * (
        2 * w.L + math.ceil(w.L / t_m) * 2 * s_eff)


def dram_ideal(w: AttnWorkload) -> float:
    """Eq. (3): read Q,K,V once, write O once."""
    return w.P * w.B * w.D * (2 * (w.H_kv * w.G) * w.L + 2 * w.H_kv * w.S)


def ideal_condition(w: AttnWorkload, l2_bytes_effective: float) -> bool:
    """Eq. (4): one K head + one V head must fit the effective L2."""
    return l2_bytes_effective > 2 * w.P * w.S * w.D


def waves_per_group(w: AttnWorkload, t_m: int, n_sm: int, o_limit: int) -> int:
    """Eq. (5): memory passes over one KV group."""
    return max(1, math.ceil(w.G * math.ceil(w.L / t_m) / (n_sm * o_limit)))


def dram_real(w: AttnWorkload, t_m: int, n_sm: int, o_limit: int) -> float:
    """Eq. (6): Q/O base traffic + KV refetched once per wave."""
    base = 2 * w.P * w.B * (w.H_kv * w.G) * w.L * w.D
    kv = 2 * w.P * w.B * w.H_kv * w.S * w.D
    return base + kv * waves_per_group(w, t_m, n_sm, o_limit)


def analyze(w: AttnWorkload, cfg: GPUMachine, *, t_m: int = 64,
            t_n: Optional[int] = None, tiling=None,
            kernel: Union[str, "object"] = "fa3",
            l2_effective_fraction: float = 0.5,
            l2_bw_bytes_per_s: Optional[float] = None) -> TrafficReport:
    """Full SimFA-python report for one attention kernel invocation.

    The traffic terms go through the registered kernel's hooks so Eq. 2/6
    specialize per scenario (``kernel="fa3"`` reproduces the paper's
    closed forms above exactly).  Pass the same ``tiling`` the simulation
    used and the hooks (and the ``t_m``/``t_n`` the ramp term charges)
    follow it; otherwise the kernel's default tiling applies (paper
    reference 64x176 for FA3).  l2_effective_fraction=0.5 follows §6.2.2:
    half the nominal L2 is used as the effective boundary on
    partitioned-L2 parts (H800).
    """
    spec = kernel_registry.get(kernel)
    if tiling is not None:
        t_m = getattr(tiling, "t_m", t_m)
        if t_n is None:
            t_n = getattr(tiling, "t_n", None)
    fl = spec.flops(w)
    l2b = spec.l2_traffic(w, t_m, tiling=tiling)
    ideal_b = spec.dram_ideal(w)
    wgrp = waves_per_group(w, t_m, cfg.num_sms, cfg.occupancy_limit)
    real_b = spec.dram_real(w, t_m, cfg.num_sms, cfg.occupancy_limit,
                            tiling=tiling)
    ideal = ideal_condition(w, cfg.l2_bytes * l2_effective_fraction)
    dram_b = ideal_b if ideal else real_b

    # Eq. (7), (11), (12)
    ratio = l2b / max(dram_b, 1.0)
    inten = fl / max(l2b, 1.0)
    inten_apx = 2.0 * t_m / w.P

    # roofline composition; L2 bandwidth defaults to the TMA-path aggregate
    # (num_sms * inflight/latency * line) — see core/memory.py calibration
    peak = cfg.peak_tflops_fp16 * 1e12
    if l2_bw_bytes_per_s is None:
        lines_per_cycle = (cfg.tma_max_inflight_lines / cfg.l2_near_latency
                           * cfg.num_sms)
        l2_bw_bytes_per_s = lines_per_cycle * cfg.line_bytes * cfg.freq_ghz * 1e9
    t_c = fl / peak
    t_l2 = l2b / l2_bw_bytes_per_s
    t_d = dram_b / (cfg.dram_bw_gbps * 1e9)

    # fill/drain: TMA setup + memory round trip for the first K tile, plus
    # two (softmax + MMA) stages before/after steady state; the bubble is
    # the same §5.2 cost the trace generators charge (shared in
    # kprog.costs), shaped by the dispatched kernel at the tiling's t_n
    if t_n is None:
        t_n = getattr(spec.default_tiling(), "t_n", DEFAULT_T_N)
    bubble = spec.ramp_bubble_cycles(cfg, w, t_m, t_n)
    mma = (w.D // 16) * max(1, int(t_n / cfg.wgmma_n_cycles_divisor)) / 8
    ramp_cycles = (cfg.tma_launch_latency + cfg.tma_tmap_setup_latency
                   + cfg.l2_near_latency + cfg.dram_latency
                   + 2 * (bubble + mma))
    t_ramp = ramp_cycles / (cfg.freq_ghz * 1e9)
    return TrafficReport(
        flops=fl, l2_bytes=l2b, dram_ideal_bytes=ideal_b,
        dram_real_bytes=real_b, ideal_regime=ideal, waves_per_group=wgrp,
        traffic_ratio=ratio, intensity_l2=inten, intensity_approx=inten_apx,
        t_compute=t_c, t_l2=t_l2, t_dram=t_d, t_ramp=t_ramp)
