"""GenZ-like ideal-cache baseline (paper §6.2.3 comparison).

GenZ-style analytical models count DRAM traffic under an ideal-cache
assumption: every tensor moves between DRAM and the chip exactly once. The
paper shows this slightly *over*-estimates at short sequences (no credit for
request coalescing of Q/O partial lines) and severely *under*-estimates at
long sequences (no capacity-induced K/V refetch). We reproduce that
baseline so benchmarks can plot both against SimFA-python.
"""
from __future__ import annotations

from repro_torch.configs.llama3 import AttnWorkload
from repro_torch.core.machine import GPUMachine


def genz_dram_traffic(w: AttnWorkload) -> float:
    """Ideal-cache DRAM bytes: Q + K + V read once, O written once."""
    q_o = 2 * w.P * w.B * (w.H_kv * w.G) * w.L * w.D
    kv = 2 * w.P * w.B * w.H_kv * w.S * w.D
    return q_o + kv


def genz_latency(w: AttnWorkload, cfg: GPUMachine) -> float:
    """max(compute, DRAM) roofline — no L2 term, no wave model."""
    f = 4.0 * w.B * (w.H_kv * w.G) * w.L * w.S * w.D
    if w.causal:
        f /= 2
    t_c = f / (cfg.peak_tflops_fp16 * 1e12)
    t_d = genz_dram_traffic(w) / (cfg.dram_bw_gbps * 1e9)
    return max(t_c, t_d)
