"""NCU-style per-kernel section report.

Condenses one simulated launch into the summary table Nsight Compute
prints for a real kernel: speed-of-light percentages (achieved vs. peak
DRAM / L2 / tensor-core rates), occupancy, and the 5-bucket stall
breakdown.  This is the calibration surface for machine presets (ROADMAP
item 5): the Hopper microbenchmarking papers publish exactly these
achieved rates, so a preset is validated by diffing this table against
their measurements.

Peak references come from the :class:`GPUMachine`:

  * DRAM — ``dram_bw_gbps`` (aggregate HBM);
  * L2 — ``l2_slices * line_bytes`` bytes/cycle (every slice serving one
    line per cycle, the engine's structural ceiling);
  * tensor core — ``peak_tflops_fp16`` scaled by achieved busy fraction.

``build_report`` returns a plain JSON-serializable dict (so it can ride in
``report.save_json`` artifacts); ``render_report`` pretty-prints it.
"""
from __future__ import annotations

from typing import Any, Dict, Optional


def _pct(x: float) -> float:
    return round(100.0 * x, 2)


def build_report(result, cfg, *, workload=None,
                 manifest: Optional[dict] = None) -> Dict[str, Any]:
    """Build the section report for one :class:`SimResult` against machine
    ``cfg``.  Uses ``result.counters`` (occupancy, ring depths) and
    ``result.trace`` (stall buckets) when the run recorded them; sections
    without their source simply don't appear."""
    seconds = result.latency_us * 1e-6
    dram_gbps = result.dram_bytes / seconds / 1e9 if seconds else 0.0
    l2_gbps = result.l2_delivered_bytes / seconds / 1e9 if seconds else 0.0
    l2_peak_gbps = cfg.l2_slices * cfg.line_bytes * cfg.freq_ghz
    tc_frac = result.tc_util

    rep: Dict[str, Any] = {
        "kernel": result.kernel,
        "fidelity": result.fidelity,
        "cycles": result.cycles,
        "latency_us": round(result.latency_us, 3),
        "deadlocked": result.deadlocked,
        "launch": {
            "ctas_total": result.n_ctas_total,
            "ctas_simulated": result.n_ctas_simulated,
            "waves": round(result.n_ctas_total /
                           (cfg.num_sms * cfg.occupancy_limit), 3),
        },
        "speed_of_light": {
            "dram_gbps": round(dram_gbps, 1),
            "dram_peak_gbps": cfg.dram_bw_gbps,
            "dram_pct": _pct(dram_gbps / cfg.dram_bw_gbps),
            "l2_gbps": round(l2_gbps, 1),
            "l2_peak_gbps": round(l2_peak_gbps, 1),
            "l2_pct": _pct(l2_gbps / l2_peak_gbps),
            "tensorcore_pct": _pct(tc_frac),
            "tensorcore_tflops": round(tc_frac * cfg.peak_tflops_fp16, 1),
            "sol_pct": _pct(max(dram_gbps / cfg.dram_bw_gbps,
                                l2_gbps / l2_peak_gbps, tc_frac)),
        },
        "memory": {
            "dram_bytes": result.dram_bytes,
            "l2_demand_bytes": result.l2_bytes,
            "l2_delivered_bytes": result.l2_delivered_bytes,
            "l2_stats": result.l2_stats,
        },
    }
    if workload is not None:
        rep["workload"] = getattr(workload, "name", str(workload))

    dl = getattr(result, "deadlock_info", None)
    if dl is not None:
        rep["deadlock"] = dl     # analysis.hazards.explain_deadlock dict
    hz = getattr(result, "hazards", None)
    if hz:
        rep["hazards"] = [i.render() for i in hz]
    fs = getattr(result, "fault_stats", None)
    if fs is not None:
        rep["faults"] = fs       # faults.FaultSession.stats() dict
    if getattr(result, "aborted", False):
        ai = getattr(result, "abort_info", None) or {}
        rep["abort"] = {k: ai.get(k) for k in
                        ("reason", "cycle", "wall_s", "launched", "retired",
                         "in_flight", "pending")}

    snk = getattr(result, "counters", None)
    if snk is not None and snk.cycles:
        occ_limit = cfg.num_sms * cfg.occupancy_limit
        avg = snk.avg_resident_ctas()
        rep["occupancy"] = {
            "avg_resident_ctas": round(avg, 2),
            "limit_ctas": occ_limit,
            "pct": _pct(avg / occ_limit),
        }
        maxd = snk.ring_max_depths()
        if maxd:
            rep["rings"] = {
                f"cta{cta}/{ring}": {
                    "peak_depth": depth,
                    "declared": snk.ring_depths[(cta, ring)],
                }
                for (cta, ring), depth in sorted(maxd.items())[:16]
            }
        if snk.tma_inflight:
            rep["tma"] = {
                "peak_inflight_lines": max(snk.tma_inflight),
                "limit_per_job": cfg.tma_max_inflight_lines,
            }

    trace = getattr(result, "trace", None)
    if trace is not None and trace.events:
        from repro_torch.analysis import dag as dag_mod
        from repro_torch.analysis.critical_path import attribute_stalls

        sr = attribute_stalls(dag_mod.build(trace.events,
                                            trace.dispatch_parent))
        totals = sr.totals()
        stalled = sum(totals.values())
        rep["stalls"] = {
            "total_stall_cycles": round(stalled, 1),
            "buckets": {k: round(v, 1) for k, v in totals.items()},
            "by_role": {role: {k: round(v, 1) for k, v in b.items()}
                        for role, b in sr.by_role().items()},
        }

    if manifest is not None:
        rep["manifest"] = manifest
    return rep


def render_report(rep: Dict[str, Any]) -> str:
    """Pretty-print a section report (the NCU table look)."""
    L = []
    hdr = f"{rep['kernel']}  [{rep['fidelity']}]"
    L.append(hdr)
    L.append("=" * len(hdr))
    L.append(f"  cycles {rep['cycles']:>12.0f}    latency"
             f" {rep['latency_us']:.1f} us"
             + ("    ** DEADLOCKED **" if rep.get("deadlocked") else "")
             + ("    ** ABORTED **" if rep.get("abort") else ""))
    if rep.get("abort"):
        ab = rep["abort"]
        L.append(f"  watchdog abort ({ab.get('reason')}): cycle"
                 f" {ab.get('cycle')}, {ab.get('retired')}/"
                 f"{ab.get('launched')} CTAs retired,"
                 f" {ab.get('pending')} pending,"
                 f" {ab.get('wall_s')} s wall")
    if rep.get("deadlock"):
        from repro_torch.analysis.hazards import render_deadlock
        L.extend(render_deadlock(rep["deadlock"]))
    for line in rep.get("hazards", ()):
        L.append(f"  sanitizer: {line}")
    la = rep["launch"]
    L.append(f"  ctas {la['ctas_total']} (simulated"
             f" {la['ctas_simulated']}), {la['waves']} waves")
    sol = rep["speed_of_light"]
    L.append("  -- speed of light " + "-" * 40)
    L.append(f"  DRAM        {sol['dram_gbps']:>8.1f} /"
             f" {sol['dram_peak_gbps']:>7.1f} GB/s   {sol['dram_pct']:>6.2f} %")
    L.append(f"  L2          {sol['l2_gbps']:>8.1f} /"
             f" {sol['l2_peak_gbps']:>7.1f} GB/s   {sol['l2_pct']:>6.2f} %")
    L.append(f"  TensorCore  {sol['tensorcore_tflops']:>8.1f} TFLOP/s"
             f"             {sol['tensorcore_pct']:>6.2f} %")
    L.append(f"  SOL                                      "
             f"{sol['sol_pct']:>6.2f} %")
    if "occupancy" in rep:
        oc = rep["occupancy"]
        L.append(f"  occupancy   {oc['avg_resident_ctas']:>8.2f} /"
                 f" {oc['limit_ctas']:>4d} CTAs     {oc['pct']:>6.2f} %")
    if "tma" in rep:
        L.append(f"  TMA peak in-flight {rep['tma']['peak_inflight_lines']}"
                 f" lines (limit {rep['tma']['limit_per_job']}/job)")
    if "rings" in rep:
        L.append("  -- ring occupancy (peak/declared) " + "-" * 24)
        for name, r in rep["rings"].items():
            L.append(f"  {name:<20s} {r['peak_depth']}/{r['declared']}")
    if "stalls" in rep:
        st = rep["stalls"]
        L.append("  -- stall breakdown " + "-" * 39)
        for k, v in sorted(st["buckets"].items(), key=lambda kv: -kv[1]):
            L.append(f"  {k:<18s} {v:>12.1f} cycles")
    if "faults" in rep:
        f = rep["faults"]
        plan = f.get("plan", {})
        L.append("  -- fault injection " + "-" * 39)
        L.append(f"  plan {plan.get('name') or '<unnamed>'}"
                 f"  seed {plan.get('seed')}"
                 + ("  (identity)" if plan.get("identity") else ""))
        ev = f.get("injection_events", {})
        for k, v in sorted(f.get("injected_cycles", {}).items(),
                           key=lambda kv: -kv[1]):
            if v:
                L.append(f"  {k:<12s} +{v:>10d} cycles over"
                         f" {ev.get(k, 0)} events")
        if f.get("offline_sms"):
            L.append(f"  offline SMs: {f['offline_sms']}")
    man = rep.get("manifest") or {}
    if man:
        L.append(f"  [{man.get('git_sha', '?')} @"
                 f" {man.get('host_id', '?')}"
                 f" {man.get('scheduler', '')}]".rstrip())
    return "\n".join(L)
