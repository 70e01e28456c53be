"""What-if replay: predict launch latency under scaled resource costs
without re-running the cycle engine.

The DAG is replayed in topological (event-id) order: each node starts at the
latest of its predecessors' releases plus its recorded scheduler slack, and
its duration is scaled by the knob for its resource class:

  * ``tma_bw``  — scales the post-setup (streaming) portion of every TMA
                  job; the descriptor/launch setup cycles (``fixed``) are
                  latency, not bandwidth, and are left alone;
  * ``wgmma``   — scales tensor-core execution time;
  * ``softmax`` — scales CUDA-core bubble blocks (e.g. a MUFU-rich vs
                  MUFU-poor softmax variant).

With every knob at x1.0 the replay reproduces the simulated schedule
*exactly* (slack is the measured residual, so starts telescope back to the
measured starts) — that identity is the validation anchor, and re-simulation
agreement on scaled knobs is checked by ``validate_replay`` /
``benchmarks/bench_whatif.py``.

Approximations (documented, deliberate): memory-system contention inside a
TMA job's measured duration is scaled together with the streaming portion;
scheduler slack is held fixed; edge matching is the measured one (a knob
change never re-matches which signal a wait consumed).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, replace
from typing import Dict, List

from repro_torch.analysis.dag import END, PipelineDAG
from repro_torch.analysis.events import BUBBLE, MMA, TMA


@dataclass(frozen=True)
class Knobs:
    tma_bw: float = 1.0        # TMA streaming bandwidth multiplier
    wgmma: float = 1.0         # tensor-core throughput multiplier
    softmax: float = 1.0       # CUDA-core (bubble) throughput multiplier

    def label(self) -> str:
        return (f"tma x{self.tma_bw:g} / wgmma x{self.wgmma:g} / "
                f"softmax x{self.softmax:g}")

    def is_baseline(self) -> bool:
        return self.tma_bw == self.wgmma == self.softmax == 1.0


@dataclass
class ReplayResult:
    knobs: Knobs
    makespan: float            # predicted cycles
    baseline: int              # measured (simulated) cycles
    replay_s: float            # wall time of the replay itself

    @property
    def speedup(self) -> float:
        """Predicted kernel speedup vs the measured baseline."""
        return self.baseline / self.makespan if self.makespan else float("inf")


def replay(dag: PipelineDAG, knobs: Knobs = Knobs()) -> ReplayResult:
    t_wall = time.perf_counter()
    n = len(dag.events)
    t1 = [0.0] * n             # lane-occupancy end
    done = [0.0] * n           # effect completion
    for e in dag.events:
        ready = 0.0
        for pe, mode in dag.preds[e.eid]:
            v = t1[pe] if mode == END else done[pe]
            if v > ready:
                ready = v
        start = ready + dag.slack[e.eid]
        dur = e.t1 - e.t0
        if e.kind == BUBBLE:
            occ = dur / knobs.softmax
            t1[e.eid] = done[e.eid] = start + occ
        elif e.kind == MMA:
            t1[e.eid] = done[e.eid] = start + dur / knobs.wgmma
        elif e.kind == TMA:
            stream = max(0, dur - e.fixed)
            t1[e.eid] = done[e.eid] = start + e.fixed + stream / knobs.tma_bw
        else:                   # issue: zero occupancy
            t1[e.eid] = done[e.eid] = start
    mk = max(done) if done else 0.0
    return ReplayResult(knobs=knobs, makespan=mk, baseline=dag.makespan,
                        replay_s=time.perf_counter() - t_wall)


def replay_grid(dag: PipelineDAG, grid: List[Knobs]) -> List[ReplayResult]:
    return [replay(dag, k) for k in grid]


# ---------------------------------------------------------------------------
# validation against real re-simulation
# ---------------------------------------------------------------------------

def machine_for(cfg, knobs: Knobs):
    """The machine variant a knob point corresponds to, for re-simulation.

    ``wgmma``/``softmax`` map exactly onto machine parameters; ``tma_bw``
    maps onto the integer lines-per-cycle rate, so only integer-compatible
    factors (0.5, 2, ...) re-simulate faithfully.
    """
    kw = {}
    if knobs.wgmma != 1.0:
        kw["wgmma_n_cycles_divisor"] = cfg.wgmma_n_cycles_divisor * knobs.wgmma
    if knobs.softmax != 1.0:
        kw["mufu_ops_per_cycle"] = max(1, int(round(
            cfg.mufu_ops_per_cycle * knobs.softmax)))
        kw["fp32_ops_per_cycle"] = max(1, int(round(
            cfg.fp32_ops_per_cycle * knobs.softmax)))
        kw["fp16_ops_per_cycle"] = max(1, int(round(
            cfg.fp16_ops_per_cycle * knobs.softmax)))
    if knobs.tma_bw != 1.0:
        kw["tma_lines_per_cycle"] = max(1, int(round(
            cfg.tma_lines_per_cycle * knobs.tma_bw)))
    return replace(cfg, **kw)


def validate_replay(w, cfg, knobs: Knobs = Knobs(), *, fidelity: str = "full",
                    tiling=None, rel_tol: float = 0.01) -> Dict:
    """Replay prediction vs a real re-simulation of the same knob point.

    Returns a comparison row; with all knobs at x1.0 the prediction must
    match the baseline engine makespan to ``rel_tol`` (acceptance criterion).
    """
    from repro_torch.analysis import dag as dag_mod
    from repro_torch.core.simfa import simulate_fa3
    from repro_torch.core.tracegen_fa3 import FA3Tiling

    tiling = tiling or FA3Tiling()
    base = simulate_fa3(w, cfg, tiling=tiling, fidelity=fidelity,
                        record_events=True)
    dag = dag_mod.build(base.trace.events, base.trace.dispatch_parent)
    pred = replay(dag, knobs)
    # hierarchical fidelity records only the first simulated wave; scale the
    # composed total by the replayed wave ratio (same rule as sweep._sweep_one)
    pred_cycles = base.cycles * pred.makespan / max(dag.makespan, 1)
    if knobs.is_baseline():
        resim_cycles = base.cycles
    else:
        resim = simulate_fa3(w, cfg=machine_for(cfg, knobs), tiling=tiling,
                             fidelity=fidelity)
        resim_cycles = resim.cycles
    err = abs(pred_cycles - resim_cycles) / max(resim_cycles, 1e-9)
    return {
        "workload": w.name, "knobs": knobs.label(),
        "baseline_cycles": base.cycles, "pred_cycles": pred_cycles,
        "resim_cycles": resim_cycles, "rel_err": err, "ok": err <= rel_tol,
    }
