"""High-level Sim-FA driver: simulate one attention-kernel launch.

The kernel program is resolved through the kernel registry
(``repro_torch.core.kprog``): ``kernel="fa3"`` (default, the paper's ping-pong
FA3), ``"fa3_cooperative"``, ``"fa2"`` (non-specialized ablation baseline)
or ``"splitkv_decode"`` (FlashDecoding-style serving workload) — or any
externally registered :class:`~repro_torch.core.kprog.ir.KernelSpec`.

Fidelity modes (§2.3: cycle simulation is prohibitively slow on large
workloads, so a corrected analytical model substitutes — we make the
substitution structured instead of ad hoc):

  * ``full``          — every CTA on every SM, line-exact memory.
  * ``tile``          — every CTA on every SM, tile-granular memory
    (``Engine(mem_fidelity="tile")``): traffic counters byte-identical to
    ``full``, cycles within the docs/fidelity.md error bound, ~10x faster.
    Requires the L2 request coalescer (``lrc_enabled`` machines).
  * ``hierarchical``  — simulate ``n_sub`` SMs (memory system scaled
    proportionally) for two waves; total latency composes the measured
    first-wave latency with the measured marginal (steady-state) wave cost
    times the remaining wave count. Traffic scales with the CTA ratio.
  * ``auto``          — precedence ``full`` -> ``tile`` -> ``hierarchical``:
    full when the launch fits ``FULL_CTA_LIMIT``, tile while it fits
    ``TILE_CTA_LIMIT`` (the ~10x engine speedup buys that headroom at
    bounded cycle error), hierarchical beyond that.  An *explicit*
    fidelity is always respected — no silent re-selection on large
    launches.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional, Union

from repro_torch.configs.llama3 import AttnWorkload
from repro_torch.core import analytical
from repro_torch.core.engine import Engine
from repro_torch.core.kprog import registry as kernel_registry
from repro_torch.core.kprog.ir import KernelSpec
from repro_torch.core.machine import GPUMachine
from repro_torch.obs.counters import CounterSink
from repro_torch.obs.manifest import build_manifest

FULL_CTA_LIMIT = 600
# the tile engine is ~10x faster than line-exact on the same launch
# (docs/fidelity.md), so auto keeps cycle simulation ~10x longer before
# falling back to the hierarchical wave model
TILE_CTA_LIMIT = 6000

FIDELITIES = ("auto", "full", "tile", "hierarchical")


@dataclass
class SimResult:
    latency_us: float
    cycles: float
    fidelity: str
    n_ctas_total: int
    n_ctas_simulated: int
    tc_util: float
    l2_bytes: float            # demand traffic issued toward L2 (pre-LRC,
                               # what Eq. 2 models), extrapolated
    l2_delivered_bytes: float  # post-LRC requests that reached the L2
    dram_bytes: float          # extrapolated DRAM traffic
    l2_stats: dict
    deadlocked: bool
    kernel: str = "fa3"
    gantt: Optional[list] = None
    trace: Optional[object] = None   # analysis.events.EventTracer of the
                                     # (first) simulated engine run
    counters: Optional[object] = None  # obs.counters.CounterSink of the
                                       # (first) simulated engine run
    manifest: Optional[dict] = None    # obs.manifest provenance stamp
    deadlock_info: Optional[dict] = None  # analysis.hazards.explain_deadlock
                                          # snapshot when deadlocked
    hazards: Optional[list] = None     # analysis.hazards.HazardIssue list
                                       # when the engine ran sanitize=True
    aborted: bool = False              # watchdog tripped mid-run; cycles /
                                       # traffic below are the salvaged
                                       # partial run, not a completed launch
    abort_info: Optional[dict] = None  # faults.watchdog.salvage snapshot
    fault_stats: Optional[dict] = None  # faults.FaultSession.stats() when a
                                        # fault plan was attached
    mem_fidelity: str = "line"  # engine memory model that produced the run
                                # ("line" exact / "tile" bulk transactions)


def _run(cfg, ctas, tmaps, n_sms, mem_scale, record_gantt=False,
         engine_opts=None, counters=None):
    eng = Engine(cfg, n_sms=n_sms, mem_scale=mem_scale,
                 record_gantt=record_gantt, counters=counters,
                 **(engine_opts or {}))
    for tm in tmaps.values():
        eng.define_tmap(tm)
    eng.launch(ctas)
    st = eng.run()
    return eng, st


def simulate_fa3(w: AttnWorkload, cfg: GPUMachine,
                 tiling=None, fidelity: str = "auto",
                 n_sub: int = 8, record_gantt: bool = False,
                 record_events: bool = False,
                 record_counters: bool = False,
                 counter_window: int = 256,
                 engine_opts: Optional[dict] = None,
                 kernel: Union[str, KernelSpec] = "fa3",
                 faults=None, watchdog=None) -> SimResult:
    """Simulate one kernel launch (name kept for history; ``kernel=``
    dispatches through the registry, defaulting to the FA3 ping-pong the
    driver originally hardcoded).  ``tiling=None`` takes the spec's
    default tiling.  ``engine_opts`` forwards to :class:`Engine` — e.g.
    ``{"scheduler": "waiter"}`` to pin a fallback scheduler.

    ``record_counters=True`` attaches an :class:`obs.counters.CounterSink`
    (windowed PM-counter timelines on ``SimResult.counters``) to the first
    simulated engine run; it is bit-neutral — cycles and stats do not
    change.  Every result carries an ``obs.manifest`` provenance stamp.

    ``faults=`` attaches a :class:`repro_torch.faults.FaultPlan` (or its
    ``to_dict`` form) to every simulated engine run — identity plans are
    bit-exact, seeded plans reproducible.  ``watchdog=`` attaches a
    :class:`repro_torch.faults.Watchdog` budget; on trip the result comes back
    with ``aborted=True`` and the salvaged partial state in
    ``abort_info`` instead of hanging."""
    spec = kernel_registry.get(kernel)
    if fidelity not in FIDELITIES:
        raise ValueError(f"fidelity must be one of {FIDELITIES}, "
                         f"got {fidelity!r}")
    if faults is not None or watchdog is not None:
        engine_opts = dict(engine_opts or {})
        if faults is not None:
            engine_opts.setdefault("faults", faults)
        if watchdog is not None:
            engine_opts.setdefault("watchdog", watchdog)
    tiling = tiling if tiling is not None else spec.default_tiling()
    # total CTA count is analytic; only the traces we will actually run are
    # materialized (hierarchical mode simulates the first two waves only)
    total = spec.total_ctas(w, tiling)
    if fidelity == "auto":
        # documented precedence: full -> tile -> hierarchical.  An explicit
        # fidelity never reaches this branch (no silent re-selection).
        # Machines without the L2 request coalescer never auto-select tile
        # (the tile front end refuses lrc_enabled=False — per-line request
        # flooding only exists at line-exact fidelity).
        if total <= FULL_CTA_LIMIT:
            fidelity = "full"
        elif total <= TILE_CTA_LIMIT and cfg.lrc_enabled:
            fidelity = "tile"
        else:
            fidelity = "hierarchical"
    if fidelity == "tile":
        # the tile tier is the full-launch engine with the tile-granular
        # memory model; an explicit engine_opts mem_fidelity wins
        engine_opts = dict(engine_opts or {})
        engine_opts.setdefault("mem_fidelity", "tile")
    cycle_exact = fidelity in ("full", "tile")
    need = total if cycle_exact else 2 * n_sub * cfg.occupancy_limit
    ctas, tmaps = spec.build(cfg, w, tiling=tiling,
                             max_ctas=min(total, need))
    record = record_gantt or record_events
    snk = CounterSink(window=counter_window) if record_counters else None
    t_wall = time.perf_counter()

    if cycle_exact:
        eng, st = _run(cfg, ctas, tmaps, cfg.num_sms, 1.0, record,
                       engine_opts, counters=snk)
        manifest = _manifest(cfg, w, spec, tiling, eng, fidelity, snk,
                             time.perf_counter() - t_wall, st["cycles"])
        return SimResult(
            latency_us=st["time_us"], cycles=st["cycles"], fidelity=fidelity,
            n_ctas_total=total, n_ctas_simulated=total,
            mem_fidelity=eng.mem_fidelity,
            tc_util=st["tc_util"],
            l2_bytes=st["tma_lines"] * cfg.line_bytes,
            l2_delivered_bytes=st["l2_req_bytes"],
            dram_bytes=st["dram_bytes"], l2_stats=st["l2"],
            deadlocked=eng.deadlocked, kernel=spec.name,
            gantt=eng.gantt() if record_gantt else None,
            trace=eng.tracer if record_events else None,
            counters=snk, manifest=manifest,
            deadlock_info=eng.deadlock_info,
            hazards=(eng.sanitizer.issues
                     if eng.sanitizer is not None else None),
            aborted=eng.aborted, abort_info=eng.abort_info,
            fault_stats=(eng.faults.stats()
                         if eng.faults is not None else None))

    # hierarchical: n_sub SMs stand in for the machine; two-wave composition
    per_wave_sub = n_sub * cfg.occupancy_limit
    scale = n_sub / cfg.num_sms
    one = ctas[:per_wave_sub]
    two = ctas[:2 * per_wave_sub]
    eng1, st1 = _run(cfg, one, tmaps, n_sub, scale, record, engine_opts,
                     counters=snk)
    if len(two) > len(one):
        eng2, st2 = _run(cfg, two, tmaps, n_sub, scale,
                         engine_opts=engine_opts)
        marginal = max(st2["cycles"] - st1["cycles"], 1)
    else:
        eng2, st2 = eng1, st1
        marginal = st1["cycles"]

    waves_total = total / (cfg.num_sms * cfg.occupancy_limit)
    extra_waves = max(0.0, waves_total - 1.0)
    cycles = st1["cycles"] + extra_waves * marginal
    # traffic extrapolation: simulated CTAs -> all CTAs
    traf_scale = total / len(two)
    manifest = _manifest(cfg, w, spec, tiling, eng1, "hierarchical", snk,
                         time.perf_counter() - t_wall, cycles)
    return SimResult(
        latency_us=cycles / (cfg.freq_ghz * 1e3), cycles=cycles,
        fidelity="hierarchical", n_ctas_total=total,
        n_ctas_simulated=len(two),
        mem_fidelity=eng1.mem_fidelity,
        tc_util=st2["tc_util"],
        l2_bytes=st2["tma_lines"] * cfg.line_bytes * traf_scale,
        l2_delivered_bytes=st2["l2_req_bytes"] * traf_scale,
        dram_bytes=st2["dram_bytes"] * traf_scale,
        l2_stats=st2["l2"], deadlocked=eng1.deadlocked or eng2.deadlocked,
        kernel=spec.name,
        gantt=eng1.gantt() if record_gantt else None,
        trace=eng1.tracer if record_events else None,
        counters=snk, manifest=manifest,
        deadlock_info=eng1.deadlock_info or eng2.deadlock_info,
        hazards=(eng1.sanitizer.issues
                 if eng1.sanitizer is not None else None),
        aborted=eng1.aborted or eng2.aborted,
        abort_info=eng1.abort_info or eng2.abort_info,
        fault_stats=(eng1.faults.stats()
                     if eng1.faults is not None else None))


def _manifest(cfg, w, spec, tiling, eng, fidelity, snk, wall_s, cycles):
    return build_manifest(
        machine=cfg, workload=w, kernel=spec.name, tiling=tiling,
        scheduler=eng.scheduler, fidelity=fidelity,
        mem_fidelity=eng.mem_fidelity,
        counter_window=snk.window if snk is not None else None,
        wall_s=wall_s, sim_cycles=int(cycles),
        events_popped=eng.evq.popped,
        faults=eng.faults.plan if eng.faults is not None else None)


# preferred, kernel-neutral name
simulate = simulate_fa3


def validate_against_analytical(w: AttnWorkload, cfg: GPUMachine,
                                kernel: Union[str, KernelSpec] = "fa3",
                                **kw) -> dict:
    """Fig.-6 style row: simulated vs analytical latency + traffic, with
    the analytical side driven through the same kernel's traffic hooks."""
    spec = kernel_registry.get(kernel)
    sim = simulate_fa3(w, cfg, kernel=spec, **kw)
    tiling = kw.get("tiling")
    tiling = tiling if tiling is not None else spec.default_tiling()
    rep = analytical.analyze(w, cfg, kernel=spec, tiling=tiling)
    ape = abs(sim.latency_us - rep.latency * 1e6) / max(rep.latency * 1e6, 1e-9)
    return {
        "workload": w.name,
        "kernel": spec.name,
        "sim_us": sim.latency_us,
        "analytical_us": rep.latency * 1e6,
        "ape": ape,
        "sim_l2_bytes": sim.l2_bytes,
        "model_l2_bytes": rep.l2_bytes,
        "sim_dram_bytes": sim.dram_bytes,
        "model_dram_bytes": rep.dram_bytes,
        "bottleneck": rep.bottleneck,
        "fidelity": sim.fidelity,
        "tc_util": sim.tc_util,
    }
