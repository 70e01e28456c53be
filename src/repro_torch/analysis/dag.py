"""Dependency-DAG construction over a PipeEvent trace.

Nodes are the events themselves (event ids are already a topological order:
the tracer creates every event after all of its causal predecessors).  Edges
carry a *release mode*:

  ``end``  — the successor waits for the predecessor's lane occupancy to end
             (program order; issue of an async op);
  ``done`` — the successor waits for the predecessor's effect
             (mbarrier signal, WGMMA group completion, stage release, ...).

Edge kinds reconstructed from event metadata (byteprofile-analysis shape —
build the DAG from the trace, then replay it under perturbed costs):

  * program order within each warpgroup lane;
  * TMA load completion -> the mbarrier wait that needed its signal ordinal;
  * consumer_release -> the producer_acquire blocked on that release ordinal;
  * BAR_ARRIVE -> the BAR_WAIT needing that arrival ordinal;
  * WGMMA execution -> the commit-group drain wait (per-SM tensor-core FIFO
    makes the highest-eid WGMMA with gid <= threshold the binding one);
  * TMA store job -> the store-group drain wait;
  * issue -> async engine op (WGMMA / TMA job);
  * per-SM tensor-core FIFO chain between consecutive WGMMA executions;
  * CTA retirement -> first instructions of the CTA dispatched into the slot.

Every node also gets a ``slack``: measured start minus the latest measured
predecessor release.  Slack is scheduler/arbitration delay the edge set does
not model (GTO issue arbitration, WGMMA issue-buffer backpressure); replay
keeps it as a fixed per-node cost, which is what makes a x1.0 replay
reproduce the simulated schedule exactly.
"""
from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.analysis import events as ev_mod
from repro_torch.analysis.events import BUBBLE, ISSUE, MMA, TMA, PipeEvent
from repro_torch.core import isa

# release modes
END, DONE = "end", "done"


@dataclass
class PipelineDAG:
    events: List[PipeEvent]
    preds: List[List[Tuple[int, str]]]          # eid -> [(pred_eid, mode)]
    ready: List[int]                            # measured max pred release
    slack: List[int]                            # t0 - ready (>= 0)
    threads: "Dict[str, List[int]]"             # label -> lane eids in order
    makespan: int
    negative_slack: int                         # diagnostic: clamped edges

    def release(self, eid: int, mode: str) -> int:
        e = self.events[eid]
        return e.t1 if mode == END else e.t_done

    def sink(self) -> int:
        return max(range(len(self.events)),
                   key=lambda i: (self.events[i].t_done, i))


def _prefix_max_by_gid(entries: List[Tuple[int, int]]):
    """[(gid, eid)] -> (sorted gids, prefix-max eids) for <=-threshold query."""
    entries = sorted(entries)
    gids = [g for g, _ in entries]
    pmax: List[int] = []
    cur = -1
    for _, e in entries:
        cur = max(cur, e)
        pmax.append(cur)
    return gids, pmax


def build(events: Sequence[PipeEvent],
          dispatch_parent: Optional[Dict[int, int]] = None) -> PipelineDAG:
    """Construct the dependency DAG for one recorded engine run."""
    dispatch_parent = dispatch_parent or {}
    n = len(events)
    preds: List[List[Tuple[int, str]]] = [[] for _ in range(n)]
    threads: Dict[str, List[int]] = defaultdict(list)

    # --- index signal producers -----------------------------------------
    load_sig: Dict[Tuple[int, int, int], int] = {}     # (cta,sid,ord)->eid
    release_sig: Dict[Tuple[int, int, int], int] = {}
    arrive_sig: Dict[Tuple[int, int, int], int] = {}
    mma_by_thread: Dict[str, List[Tuple[int, int]]] = defaultdict(list)
    store_by_thread: Dict[str, List[Tuple[int, int]]] = defaultdict(list)
    cta_events: Dict[int, List[int]] = defaultdict(list)
    for e in events:
        cta_events[e.cta].append(e.eid)
        if e.kind in (ISSUE, BUBBLE):
            threads[e.label].append(e.eid)
            if e.op == isa.RELEASE_STAGE:
                release_sig[(e.cta, e.sid, e.dep_n)] = e.eid
            elif e.op == isa.BAR_ARRIVE:
                arrive_sig[(e.cta, e.bid, e.dep_n)] = e.eid
        elif e.kind == TMA and e.op == ev_mod.TMA_LOAD_JOB:
            load_sig[(e.cta, e.sid, e.dep_n)] = e.eid
        elif e.kind == TMA:
            store_by_thread[e.label].append((e.gid, e.eid))
        elif e.kind == MMA:
            mma_by_thread[e.label].append((e.gid, e.eid))

    mma_idx = {lbl: _prefix_max_by_gid(v) for lbl, v in mma_by_thread.items()}

    # --- terminal events per CTA (for dispatch edges) --------------------
    def terminals(cta: int) -> List[int]:
        last: Dict[Tuple[str, str], int] = {}
        for eid in cta_events[cta]:
            e = events[eid]
            last[(e.label, e.kind if e.kind in (MMA, TMA) else "lane")] = eid
        return sorted(last.values())

    # --- edges ------------------------------------------------------------
    last_lane: Dict[str, int] = {}
    last_mma_on_sm: Dict[int, int] = {}
    for e in events:
        p = preds[e.eid]
        if e.kind in (ISSUE, BUBBLE):
            prev = last_lane.get(e.label)
            if prev is not None:
                p.append((prev, END))                      # program order
            elif e.cta in dispatch_parent:
                for t in terminals(dispatch_parent[e.cta]):
                    p.append((t, DONE))                    # slot hand-off
            last_lane[e.label] = e.eid
            op = e.op
            if op == isa.MB_WAIT:
                src = load_sig.get((e.cta, e.sid, e.dep_n))
                if src is not None:
                    p.append((src, DONE))
            elif op == isa.ACQUIRE_STAGE and e.dep_n > 0:
                src = release_sig.get((e.cta, e.sid, e.dep_n))
                if src is not None:
                    p.append((src, DONE))
            elif op == isa.BAR_WAIT:
                src = arrive_sig.get((e.cta, e.bid, e.dep_n))
                if src is not None:
                    p.append((src, DONE))
            elif op == isa.WGMMA_WAIT:
                idx = mma_idx.get(e.label)
                if idx:
                    gids, pmax = idx
                    i = bisect.bisect_right(gids, e.dep_n) - 1
                    if i >= 0 and pmax[i] < e.eid:
                        p.append((pmax[i], DONE))
            elif op == isa.TMA_WAIT:
                for gid, seid in store_by_thread.get(e.label, ()):
                    if gid <= e.dep_n and seid < e.eid:
                        p.append((seid, DONE))
        else:                                              # engine events
            if e.src >= 0:
                p.append((e.src, END))
            if e.kind == MMA:
                prev = last_mma_on_sm.get(e.sm)
                if prev is not None:
                    p.append((prev, DONE))                 # TC FIFO chain
                last_mma_on_sm[e.sm] = e.eid

    # --- slack -----------------------------------------------------------
    ready = [0] * n
    slack = [0] * n
    negative = 0
    for e in events:
        r = 0
        for pe, mode in preds[e.eid]:
            v = events[pe].t1 if mode == END else events[pe].t_done
            if v > r:
                r = v
        ready[e.eid] = r
        s = e.t0 - r
        if s < 0:
            negative += 1
            s = 0
        slack[e.eid] = s

    makespan = max((e.t_done for e in events), default=0)
    return PipelineDAG(events=list(events), preds=preds, ready=ready,
                       slack=slack, threads=dict(threads), makespan=makespan,
                       negative_slack=negative)


def from_engine(eng) -> PipelineDAG:
    """Build the DAG from an Engine run with an attached tracer."""
    if eng.tracer is None:
        raise ValueError("engine was run without an EventTracer "
                         "(pass record_gantt=True or tracer=EventTracer())")
    return build(eng.tracer.events, eng.tracer.dispatch_parent)
