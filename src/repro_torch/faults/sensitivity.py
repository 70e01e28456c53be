"""Perturbation-magnitude sensitivity sweeps (the robustness analogue of
``analysis.whatif``).

``analysis.whatif`` asks "what if the machine were *better* along one
axis"; this module asks "how fast does the prediction degrade as measured
variability grows".  The sweep axis is the ``scale`` knob of
:func:`repro_torch.faults.measured_variability` — 0 is the paper's ideal
locked-frequency model (and bit-exact with no plan at all), 1 is the
microbenchmarked Hopper spread, >1 is stress — optionally crossed with
seeds for Monte-Carlo spread at each magnitude.

Two consumers:

  * ``benchmarks/bench_faults.py`` — per-kernel latency + stall-attribution
    degradation curves, written as a JSON artifact and smoke-checked in CI;
  * ``serve.engine.StragglerPolicy.from_samples`` — via
    :func:`step_time_samples`, which Monte-Carlos one workload's step time
    under a plan so the serving deadline comes from the modeled tail
    instead of a hand-picked factor.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from repro_torch.faults import FaultPlan, measured_variability

DEFAULT_SCALES = (0.0, 0.5, 1.0, 2.0, 4.0)


def _stall_buckets(result) -> Optional[Dict[str, float]]:
    trace = getattr(result, "trace", None)
    if trace is None or not trace.events:
        return None
    from repro_torch.analysis import dag as dag_mod
    from repro_torch.analysis.critical_path import attribute_stalls
    sr = attribute_stalls(dag_mod.build(trace.events, trace.dispatch_parent))
    return {k: round(v, 1) for k, v in sr.totals().items()}


def sensitivity_sweep(workload, cfg, *,
                      kernel: str = "fa3",
                      fidelity: str = "auto",
                      scales: Sequence[float] = DEFAULT_SCALES,
                      seeds: Sequence[int] = (0,),
                      throttle: bool = False,
                      record_stalls: bool = True,
                      watchdog=None) -> List[Dict]:
    """One latency/stall degradation curve: rows for every (scale, seed).

    Each row reports cycles, latency, the degradation ratio vs. the
    scale-0 baseline (same kernel, same fidelity), the per-category
    injected-cycle totals, and — when ``record_stalls`` — the 5-bucket
    stall attribution so the curve shows *where* the lost cycles went
    (e.g. L2 jitter surfacing as consumer mbarrier waits)."""
    from repro_torch.core.simfa import simulate_fa3

    rows: List[Dict] = []
    base_cycles: Optional[float] = None
    for scale in scales:
        for seed in seeds:
            plan = (FaultPlan.identity() if scale == 0
                    else measured_variability(scale=scale, seed=seed,
                                              throttle=throttle))
            r = simulate_fa3(workload, cfg, kernel=kernel, fidelity=fidelity,
                             record_events=record_stalls, faults=plan,
                             watchdog=watchdog)
            if base_cycles is None:
                base_cycles = r.cycles
            row = {
                "workload": workload.name,
                "kernel": r.kernel,
                "fidelity": r.fidelity,
                "scale": scale,
                "seed": seed,
                "plan": plan.name,
                "cycles": r.cycles,
                "latency_us": r.latency_us,
                "degradation": r.cycles / max(base_cycles, 1e-9),
                "aborted": r.aborted,
                "injected_cycles": (r.fault_stats or {}).get(
                    "injected_cycles"),
            }
            if record_stalls:
                row["stall_buckets"] = _stall_buckets(r)
            rows.append(row)
    return rows


def degradation_curve(rows: Sequence[Dict]) -> List[Dict]:
    """Collapse Monte-Carlo rows to one point per scale: mean / min / max
    degradation (the published curve shape)."""
    by_scale: Dict[float, List[float]] = {}
    for r in rows:
        by_scale.setdefault(r["scale"], []).append(r["degradation"])
    return [{"scale": s,
             "mean": sum(v) / len(v),
             "min": min(v),
             "max": max(v),
             "n": len(v)}
            for s, v in sorted(by_scale.items())]


def step_time_samples(workload, cfg, *,
                      kernel: str = "fa3",
                      fidelity: str = "auto",
                      scale: float = 1.0,
                      n: int = 16,
                      seed0: int = 0,
                      throttle: bool = False) -> List[float]:
    """Monte-Carlo one workload's step time (seconds) under the measured-
    variability plan at ``scale`` — ``n`` independent seeds, one latency
    sample each.  Feed the list straight to
    ``StragglerPolicy.from_samples`` to calibrate a serving deadline from
    the modeled distribution."""
    from repro_torch.core.simfa import simulate_fa3

    out: List[float] = []
    for i in range(n):
        plan = measured_variability(scale=scale, seed=seed0 + i,
                                    throttle=throttle)
        r = simulate_fa3(workload, cfg, kernel=kernel, fidelity=fidelity,
                         faults=plan)
        out.append(r.latency_us * 1e-6)
    return out
