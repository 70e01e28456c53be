"""Simulated performance-monitor counters (the NCU-style metrics surface).

The cycle engine's ``stats()`` are end-of-run totals and the event trace is
per-instruction — neither answers "what did DRAM bandwidth look like over
the kernel" the way Nsight-Compute / nvprof counter timelines do for real
GPUs (the Hopper microbenchmarking ground truth arrives exactly as such
counters).  :class:`CounterSink` fills that gap by *sampling* engine state
at N-cycle window boundaries:

  * the run loop checks one integer per iteration (``cycle >=
    sink.next_sample``) and calls :meth:`sample` at most once per crossed
    window boundary — the ~565k per-line cache events of a full launch are
    never touched individually, so counters stay cheap when on and one
    branch when off;
  * :meth:`sample` only *reads* engine state (cumulative stats counters,
    instantaneous queue depths) — it mutates nothing, which is what makes
    the sink bit-neutral by construction (``sim_cycles`` and ``stats()``
    identical with the sink on or off, enforced in
    ``tests/test_engine_equiv.py``).

Sampled series (cumulative unless noted):

  ``dram_bytes``, ``dram_busy``   — DRAM bytes served / channel-busy cycles
  ``l2_hits/misses/merges/requests`` — L2 slice counters (post-LRC)
  ``lrc_merged``                  — LRC duplicate-line merges
  ``tma_lines``                   — TMA lines issued across all SMs
  ``tma_inflight``                — instantaneous in-flight TMA lines
  ``resident_ctas``               — instantaneous resident CTA count
  ``tc_busy[sm]``                 — per-SM tensor-core busy cycles
  ``ring_occupancy[(cta, ring)]`` — instantaneous filled stages per declared
                                    ring buffer (kernel-IR ``rings`` metadata)

Windowed rates/utilizations are derived views over consecutive samples
(:meth:`dram_bw_timeline`, :meth:`l2_hit_rate_timeline`, ...).  Because the
event-driven scheduler jumps over quiet stretches, consecutive samples can
be *more* than ``window`` cycles apart; every derived rate therefore
normalizes by the measured interval, and the conservation invariants
(integral of a timeline == the engine total) hold exactly regardless of
sampling cadence — see ``tests/test_obs.py``.

Per-role stall-reason timelines are a different beast: they derive from the
recorded :class:`~repro_torch.analysis.events.PipeEvent` trace (the stall
*attribution* of ``analysis.critical_path`` reused as a timeline source),
not from engine sampling — see :func:`role_stall_timelines`.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from repro_torch.obs.labels import role_of

DEFAULT_WINDOW = 256


class CounterSink:
    """Opt-in PM-counter sampler attached via ``Engine(counters=...)``."""

    def __init__(self, window: int = DEFAULT_WINDOW):
        if window <= 0:
            raise ValueError("counter window must be positive")
        self.window = window
        self.next_sample = 0          # engine loop: sample when cycle >= this
        self.machine = None           # GPUMachine, captured on first sample
        # parallel sample series (index-aligned with .cycles)
        self.cycles: List[int] = []
        self.dram_bytes: List[int] = []
        self.dram_busy: List[float] = []
        self.l2_hits: List[int] = []
        self.l2_misses: List[int] = []
        self.l2_merges: List[int] = []
        self.l2_requests: List[int] = []
        self.lrc_merged: List[int] = []
        self.tma_lines: List[int] = []
        self.tma_inflight: List[int] = []       # instantaneous
        self.resident_ctas: List[int] = []      # instantaneous
        self.tc_busy: Dict[int, List[int]] = {}
        # cumulative fault-injected extra cycles per category; empty lists
        # (and empty timelines) when the engine runs without a fault plan
        self.fault_injected: Dict[str, List[int]] = {}
        # (cta_idx, ring name) -> [(cycle, filled stages)], instantaneous
        self.ring_occupancy: Dict[Tuple[int, str], List[Tuple[int, int]]] = {}
        self.ring_depths: Dict[Tuple[int, str], int] = {}   # declared stages
        self.totals: Dict[str, float] = {}
        self._finished = False

    # ------------------------------------------------------------------
    # engine-facing hooks (reads only — bit-neutrality depends on it)
    def sample(self, cycle: int, eng) -> None:
        """Snapshot engine counters at ``cycle``; called by the run loop at
        window-boundary crossings and once more at run end."""
        if self.cycles and self.cycles[-1] == cycle:
            return                     # idempotent per cycle (finish overlap)
        self.next_sample = cycle - cycle % self.window + self.window
        if self.machine is None:
            self.machine = eng.cfg
        l2 = eng.l2.stats()
        self.cycles.append(cycle)
        self.dram_bytes.append(eng.dram.bytes_served)
        self.dram_busy.append(getattr(eng.dram, "busy_cycles", 0))
        self.l2_hits.append(l2.get("hits", 0))
        self.l2_misses.append(l2.get("misses", 0))
        self.l2_merges.append(l2.get("mshr_merges", 0))
        self.l2_requests.append(l2.get("requests", 0))
        self.lrc_merged.append(eng.lrc.merged)
        lines = inflight = ctas = 0
        for sm in eng.sms:
            tma = sm.tma
            lines += tma.lines_issued
            for job in tma.jobs:
                inflight += job["inflight"]
            ctas += len(sm.ctas)
            self.tc_busy.setdefault(sm.sm_id, []).append(sm.tc.busy_cycles)
            for cta in sm.ctas:
                rings = cta.trace.rings
                if not rings:
                    continue
                mb = cta.mbarrier
                rel = cta.stage_releases
                n_cons = cta.n_consumers
                for name, sids in rings.items():
                    depth = 0
                    for sid in sids:
                        depth += mb.get(sid, 0) - rel.get(sid, 0) // n_cons
                    key = (cta.idx, name)
                    self.ring_depths.setdefault(key, len(sids))
                    self.ring_occupancy.setdefault(key, []).append(
                        (cycle, depth))
        self.tma_lines.append(lines)
        self.tma_inflight.append(inflight)
        self.resident_ctas.append(ctas)
        fl = getattr(eng, "faults", None)
        if fl is not None:
            for cat, v in fl.injected.items():
                self.fault_injected.setdefault(cat, []).append(v)

    def finish(self, cycle: int, eng) -> None:
        """Final closing sample — run once by the engine before it returns
        ``stats()`` — plus the frozen conservation totals."""
        if self._finished:
            return
        self.sample(cycle, eng)
        self._finished = True
        self.totals = {
            "cycles": cycle,
            "dram_bytes": eng.dram.bytes_served,
            "tc_busy_cycles": sum(sm.tc.busy_cycles for sm in eng.sms),
            "tma_lines": sum(sm.tma.lines_issued for sm in eng.sms),
            "l2_hits": self.l2_hits[-1] if self.l2_hits else 0,
            "l2_misses": self.l2_misses[-1] if self.l2_misses else 0,
        }

    # ------------------------------------------------------------------
    # derived views
    def windows(self) -> List[Tuple[int, int]]:
        """Consecutive sample intervals ``[(c0, c1), ...]`` (may be wider
        than ``window`` where the event loop jumped quiet stretches)."""
        return [(a, b) for a, b in zip(self.cycles, self.cycles[1:]) if b > a]

    def _deltas(self, series: List[int]) -> List[Tuple[int, int, int]]:
        out = []
        for i in range(1, len(self.cycles)):
            c0, c1 = self.cycles[i - 1], self.cycles[i]
            if c1 > c0:
                out.append((c0, c1, series[i] - series[i - 1]))
        return out

    def dram_bytes_per_window(self) -> List[Tuple[int, int, int]]:
        """``[(c0, c1, bytes), ...]`` — integrates exactly to total DRAM
        bytes served (conservation invariant)."""
        return self._deltas(self.dram_bytes)

    def dram_bw_timeline(self) -> List[Tuple[int, float]]:
        """Achieved DRAM GB/s per window, stamped at the window end."""
        f = self.machine.freq_ghz if self.machine else 1.0
        return [(c1, db / (c1 - c0) * f)          # B/cycle * Gcycle/s = GB/s
                for c0, c1, db in self._deltas(self.dram_bytes)]

    def dram_util_timeline(self) -> List[Tuple[int, float]]:
        """Fraction of peak DRAM bandwidth achieved per window."""
        if self.machine is None:
            return []
        peak = self.machine.dram_bw_gbps
        return [(c, min(1.0, bw / peak)) for c, bw in self.dram_bw_timeline()]

    def l2_bw_timeline(self) -> List[Tuple[int, float]]:
        """Delivered L2 GB/s (post-LRC requests x line bytes) per window."""
        if self.machine is None:
            return []
        lb, f = self.machine.line_bytes, self.machine.freq_ghz
        return [(c1, dreq * lb / (c1 - c0) * f)
                for c0, c1, dreq in self._deltas(self.l2_requests)]

    def l2_hit_rate_timeline(self) -> List[Tuple[int, float]]:
        """L2 hit fraction per window: hits / (hits + misses + MSHR merges).
        Windows with no L2 activity are skipped."""
        out = []
        hs = self._deltas(self.l2_hits)
        ms = self._deltas(self.l2_misses)
        gs = self._deltas(self.l2_merges)
        for (c0, c1, h), (_, _, m), (_, _, g) in zip(hs, ms, gs):
            tot = h + m + g
            if tot > 0:
                out.append((c1, h / tot))
        return out

    def tma_inflight_timeline(self) -> List[Tuple[int, int]]:
        """Instantaneous in-flight TMA lines at each sample."""
        return list(zip(self.cycles, self.tma_inflight))

    def tc_busy_per_window(self, sm_id: Optional[int] = None
                           ) -> List[Tuple[int, int, int]]:
        """Tensor-core busy cycles per window for one SM (or summed over
        all).  Busy cycles are charged at WGMMA issue, so a window can show
        more busy than elapsed cycles when long ops start inside it; the
        series still integrates exactly to ``tc_busy_cycles``."""
        if sm_id is not None:
            return self._deltas(self.tc_busy[sm_id])
        summed = [sum(v[i] for v in self.tc_busy.values())
                  for i in range(len(self.cycles))]
        return self._deltas(summed)

    def tc_util_timeline(self, sm_id: Optional[int] = None
                         ) -> List[Tuple[int, float]]:
        n = 1 if sm_id is not None else max(1, len(self.tc_busy))
        return [(c1, busy / ((c1 - c0) * n))
                for c0, c1, busy in self.tc_busy_per_window(sm_id)]

    def ring_max_depths(self) -> Dict[Tuple[int, str], int]:
        """Peak sampled occupancy per (cta, ring) — must never exceed the
        declared stage count (``ring_depths``)."""
        return {k: max(d for _, d in v) if v else 0
                for k, v in self.ring_occupancy.items()}

    def fault_injection_timeline(self, cat: str
                                 ) -> List[Tuple[int, int, int]]:
        """``[(c0, c1, extra_cycles), ...]`` fault-injected latency per
        window for one category (``dram``/``l2``/``tma``/``completion``/
        ``compute``); integrates exactly to the session's injected total.
        Empty when the run had no fault plan attached."""
        series = self.fault_injected.get(cat)
        if not series:
            return []
        return self._deltas(series)

    def avg_resident_ctas(self) -> float:
        """Time-weighted average resident CTA count (occupancy numerator)."""
        num = den = 0
        for i in range(1, len(self.cycles)):
            dt = self.cycles[i] - self.cycles[i - 1]
            num += self.resident_ctas[i - 1] * dt
            den += dt
        return num / den if den else 0.0


# ---------------------------------------------------------------------------
# per-role stall-reason timelines (PipeEvent-derived, not engine-sampled)
# ---------------------------------------------------------------------------

def role_stall_timelines(trace, window: int = DEFAULT_WINDOW
                         ) -> Dict[str, Dict[str, Dict[int, float]]]:
    """Per-declared-role stall timelines: ``role -> bucket -> {window_start:
    cycles}``, derived from a recorded :class:`EventTracer` trace by reusing
    the dependency-DAG stall attribution as a timeline source.

    Bucket semantics match ``analysis.critical_path.attribute_stalls``
    exactly (the same 5 buckets, including transitive softmax-bubble
    exposure); per (label, bucket) the windowed values sum to the
    attribution totals (float apportionment across window boundaries)."""
    from repro_torch.analysis import dag as dag_mod
    from repro_torch.analysis.critical_path import stall_timeline

    dag = dag_mod.build(trace.events, trace.dispatch_parent)
    per_label = stall_timeline(dag, window=window)
    out: Dict[str, Dict[str, Dict[int, float]]] = {}
    for label, buckets in per_label.items():
        role = role_of(label)
        acc = out.setdefault(role, {})
        for bucket, wins in buckets.items():
            b = acc.setdefault(bucket, {})
            for w0, cyc in wins.items():
                b[w0] = b.get(w0, 0.0) + cyc
    return out
