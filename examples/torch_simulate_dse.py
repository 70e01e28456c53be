"""Design-space exploration with the paper's models — three studies (the
PyTorch port's twin of ``examples/simulate_dse.py``, from the port's copy of
the simulator; it imports neither JAX nor the JAX package, and launches no
kernel):

  A. Long-context DRAM-traffic regimes on H800 (paper §6.2 / Fig. 9):
     where the ideal-cache assumption breaks, and how far GenZ-style
     models underestimate.
  B. Sim-guided tiling of the port's own bf16 forward kernel on the H100
     SXM (the paper's profiling-driven tile choice, §2.2, with SimFA-H100,
     ``core/sm90``, as the profiler) for assigned-architecture attention
     shapes: the reference picks the Pallas kernel's blocks on TPU v5e with
     SimFA-TPU, which the port does not carry; the port's kernel takes one
     setting, its K/V ring depth (``autotune_flash``).
  C. Future-hardware what-if (§3.6): sweep effective L2 capacity and SM
     count; watch the bottleneck migrate and the wave factor collapse.

    PYTHONPATH=src python examples/torch_simulate_dse.py
"""
from __future__ import annotations

import argparse

from repro_torch.configs import registry
from repro_torch.configs.llama3 import AttnWorkload, workload
from repro_torch.core import analytical
from repro_torch.core.genz_baseline import genz_dram_traffic
from repro_torch.core.machine import H800, h800_variant
from repro_torch.core.sm90.autotune import autotune_flash
from repro_torch.core.sm90.machine import H100_SXM


def study_a():
    print("=" * 72)
    print("A. DRAM traffic regimes, Llama-3 405B on H800 (GB per kernel)")
    print(f"{'seq':>8} {'regime':>10} {'waves':>6} {'SimFA':>9} "
          f"{'GenZ':>9} {'GenZ err':>9}")
    for s in (8192, 16384, 32768, 49152, 65536, 131072):
        w = workload("405B", s, batch=1)
        rep = analytical.analyze(w, H800)
        genz = genz_dram_traffic(w)
        err = (genz - rep.dram_bytes) / rep.dram_bytes
        print(f"{s:>8} {('ideal' if rep.ideal_regime else 'real'):>10} "
              f"{rep.waves_per_group:>6} {rep.dram_bytes/1e9:>9.2f} "
              f"{genz/1e9:>9.2f} {err:>+9.1%}")
    print("-> beyond the Eq.(4) boundary GenZ underestimates by the wave "
          "factor;\n   long-context DSE on ideal-cache models picks the "
          "wrong designs (paper §6.2.3)\n")


def study_b():
    """Each case's pick (``core.sm90.autotune.KernelPlan``), by arch."""
    print("=" * 72)
    print("B. SimFA-H100-guided ring depth of the bf16 forward kernel (H100 SXM)")
    cases = [
        ("qwen2.5-3b", "prefill_32k", 32768),
        ("command-r-plus-104b", "prefill_32k", 32768),
        ("dbrx-132b", "train_4k", 4096),
        ("olmo-1b", "train_4k", 4096),
    ]
    print(f"{'arch':>22} {'shape':>12} {'G':>3} {'D':>4} {'st':>3} "
          f"{'pred us':>9} {'bound':>8} {'smem KB':>8} {'ctas':>6}")
    picks = {}
    for arch, shape, seq in cases:
        cfg = registry.get(arch)
        w = AttnWorkload(name=f"{arch}-{shape}", B=1, L=seq, S=seq,
                         H_kv=cfg.num_kv_heads, G=cfg.q_group_size,
                         D=cfg.head_dim, causal=True)
        plan = autotune_flash(w, H100_SXM, causal=True)
        picks[arch] = plan
        print(f"{arch:>22} {shape:>12} {w.G:>3} {w.D:>4} {plan.stages:>3} "
              f"{plan.predicted_us:>9.1f} {plan.bottleneck:>8} "
              f"{plan.smem_bytes/1024:>8.1f} {plan.ctas:>6}")
    print("-> the framework picks kernel schedules by modeling the "
          "pipeline,\n   exactly how FA3 picks T_M/T_N by profiling "
          "(paper §2.2)\n")
    return picks


def study_c():
    print("=" * 72)
    print("C. What-if hardware sweep, Llama-3 70B @ 64K (H800 baseline)")
    w = workload("70B", 65536, batch=1)
    print(f"{'variant':>28} {'regime':>8} {'waves':>6} {'DRAM GB':>9} "
          f"{'bottleneck':>11} {'latency ms':>11}")
    variants = [
        ("H800 (50MB L2, 132 SM)", {}),
        ("2x L2 (100MB)", {"l2_bytes": 100 * 1024 * 1024}),
        ("4x L2 (200MB)", {"l2_bytes": 200 * 1024 * 1024}),
        ("2x SMs (264)", {"num_sms": 264}),
        ("2x DRAM BW", {"dram_bw_gbps": 6700.0}),
    ]
    for name, kw in variants:
        cfg = h800_variant(**kw)
        rep = analytical.analyze(w, cfg)
        print(f"{name:>28} {('ideal' if rep.ideal_regime else 'real'):>8} "
              f"{rep.waves_per_group:>6} {rep.dram_bytes/1e9:>9.2f} "
              f"{rep.bottleneck:>11} {rep.latency*1e3:>11.2f}")
    print("-> more SMs / DRAM BW do not fix long-context attention; "
          "SRAM\n   (L2 capacity -> regime, T_M -> intensity) does "
          "(paper §3.6.2)\n")


def main(argv=None):
    argparse.ArgumentParser(description=__doc__.split("\n")[0]).parse_args(argv)
    study_a()
    picks = study_b()
    study_c()
    return {"study_b": picks}


if __name__ == "__main__":
    main()
