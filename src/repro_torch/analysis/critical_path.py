"""Critical path extraction and per-warpgroup stall attribution.

The critical path is recovered by walking back from the sink (latest
completion) through each node's *binding* predecessor — the one whose
measured release time determined the node's start (ties prefer causal
``done`` edges over program order, which is the informative choice).

Stall attribution decomposes every idle cycle on every warpgroup lane into
one of five buckets (paper §6 asks exactly these questions of Fig. 7):

  ``tma-wait``       — blocked on an mbarrier fed by a TMA load, or draining
                       a TMA store group;
  ``wgmma-drain``    — blocked on a WGMMA commit-group drain;
  ``barrier-wait``   — blocked on another warpgroup (producer_acquire with
                       the ring buffer full, or a named barrier) for reasons
                       other than softmax;
  ``softmax-bubble`` — the share of a warpgroup-to-warpgroup wait whose
                       *binding causal chain* ran through a softmax bubble
                       (ping-pong exposure is transitive: the signaler may
                       itself drain WGMMAs queued behind its bubble);
  ``scheduler``      — residual issue delay the DAG does not model (GTO
                       arbitration, issue-width, WGMMA issue-buffer
                       backpressure).

The buckets of one warpgroup sum *exactly* to its idle cycles
(span - lane occupancy) by construction — tested in tests/test_analysis.py.
"""
from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, List

from repro_torch.analysis.dag import DONE, PipelineDAG
from repro_torch.analysis.events import BUBBLE, MMA, TMA
from repro_torch.core import isa
# label parsing lives in obs.labels (single source of truth for the
# cta{i}/{role} convention); role_of is re-exported here for back-compat
from repro_torch.obs.labels import role_of  # noqa: F401

BUCKETS = ("tma-wait", "wgmma-drain", "barrier-wait", "softmax-bubble",
           "scheduler")


# ---------------------------------------------------------------------------
# critical path
# ---------------------------------------------------------------------------

def critical_path(dag: PipelineDAG) -> List[int]:
    """Event ids from a source to the sink along binding predecessors."""
    path = [dag.sink()]
    while True:
        eid = path[-1]
        preds = dag.preds[eid]
        if not preds:
            break
        best, best_rel, best_causal = None, -1, False
        for pe, mode in preds:
            rel = dag.release(pe, mode)
            causal = mode == DONE
            if rel > best_rel or (rel == best_rel and causal and not best_causal):
                best, best_rel, best_causal = pe, rel, causal
        path.append(best)
    path.reverse()
    return path


def path_length(dag: PipelineDAG, path: List[int]) -> int:
    """Arrival time of the sink along the path (== makespan when the walk
    starts from the global sink)."""
    return dag.events[path[-1]].t_done


def path_summary(dag: PipelineDAG, path: List[int]) -> Dict[str, int]:
    """Decompose the path length into time spent per node class.

    Each node contributes (its release to the successor) minus (the previous
    path node's release); contributions telescope to the path length.
    """
    out: Dict[str, int] = defaultdict(int)
    prev_rel = 0
    for i, eid in enumerate(path):
        e = dag.events[eid]
        rel = e.t_done if i + 1 == len(path) else _release_to(dag, eid, path[i + 1])
        contrib = max(0, rel - prev_rel)
        prev_rel = max(prev_rel, rel)
        if e.kind == MMA:
            key = "wgmma"
        elif e.kind == TMA:
            key = "tma"
        elif e.kind == BUBBLE:
            key = "softmax"
        else:
            key = "issue"
        out[key] += contrib
    return dict(out)


def _release_to(dag: PipelineDAG, eid: int, succ: int) -> int:
    for pe, mode in dag.preds[succ]:
        if pe == eid:
            return dag.release(pe, mode)
    return dag.events[eid].t_done


# ---------------------------------------------------------------------------
# stall attribution
# ---------------------------------------------------------------------------



@dataclass
class StallReport:
    per_wg: Dict[str, Dict[str, int]]       # label -> bucket -> cycles
    meta: Dict[str, Dict[str, int]]         # label -> span/busy/idle/instrs
    makespan: int

    def totals(self) -> Dict[str, int]:
        tot: Dict[str, int] = defaultdict(int)
        for b in self.per_wg.values():
            for k, v in b.items():
                tot[k] += v
        return dict(tot)

    def by_role(self) -> Dict[str, Dict[str, int]]:
        """Buckets summed over every warpgroup of each declared role —
        the cross-CTA view keyed by the kernel spec's role names."""
        out: Dict[str, Dict[str, int]] = {}
        for label, buckets in self.per_wg.items():
            acc = out.setdefault(role_of(label), defaultdict(int))
            for k, v in buckets.items():
                acc[k] += v
            acc["idle"] += self.meta[label]["idle"]
            acc["busy"] += self.meta[label]["busy"]
        return {r: dict(b) for r, b in out.items()}


def _chain_bubble_cycles(dag: PipelineDAG, eid: int, lo: int, hi: int) -> int:
    """Bubble cycles of [lo, hi) spent on the *binding-predecessor chain*
    upstream of ``eid``.

    A barrier wait's cause is transitive: the signaling warpgroup may itself
    have been draining WGMMAs that queued behind a softmax bubble two hops
    earlier.  Walking the binding chain (the same argmax-release walk the
    critical path uses) and clipping each chain node's occupancy to the wait
    window measures how much of the wait is ultimately softmax exposure."""
    tot = 0
    cur = eid
    while True:
        preds = dag.preds[cur]
        if not preds:
            break
        best, best_rel = preds[0][0], -1
        for pe, mode in preds:
            rel = dag.release(pe, mode)
            if rel > best_rel:
                best, best_rel = pe, rel
        e = dag.events[best]
        if e.kind == BUBBLE:
            s, t = max(lo, e.t0), min(hi, e.t1)
            if t > s:
                tot += t - s
        cur = best
        if e.t0 <= lo:
            break
    return tot


def _bucket_split(dag: PipelineDAG, eid: int, lo: int, hi: int) -> Dict[str, int]:
    """Split one causal-wait window across buckets (sum == hi - lo)."""
    e = dag.events[eid]
    op = e.op
    wait = hi - lo
    if op == isa.MB_WAIT or op == isa.TMA_WAIT:
        return {"tma-wait": wait}
    if op == isa.WGMMA_WAIT:
        return {"wgmma-drain": wait}
    if op in (isa.ACQUIRE_STAGE, isa.BAR_WAIT):
        # warpgroup-to-warpgroup wait: the share of the window the binding
        # causal chain spent inside softmax bubbles is ping-pong exposure
        bub = min(wait, _chain_bubble_cycles(dag, eid, lo, hi))
        out = {"barrier-wait": wait - bub}
        if bub:
            out["softmax-bubble"] = bub
        return out
    return {"scheduler": wait}


def attribute_stalls(dag: PipelineDAG) -> StallReport:
    per_wg: Dict[str, Dict[str, int]] = {}
    meta: Dict[str, Dict[str, int]] = {}
    for label, eids in dag.threads.items():
        buckets = {b: 0 for b in BUCKETS}
        busy = 0
        for i, eid in enumerate(eids):
            e = dag.events[eid]
            busy += e.t1 - e.t0
            if i == 0:
                continue
            prev_end = dag.events[eids[i - 1]].t1
            gap = e.t0 - prev_end
            if gap <= 0:
                continue
            # the causal wait ends when the latest predecessor releases;
            # anything after that is scheduler delay
            wait = min(gap, max(0, dag.ready[eid] - prev_end))
            sched = gap - wait
            if wait:
                for k, v in _bucket_split(dag, eid, prev_end,
                                          prev_end + wait).items():
                    buckets[k] += v
            buckets["scheduler"] += sched
        first, last = dag.events[eids[0]], dag.events[eids[-1]]
        span = last.t1 - first.t0
        per_wg[label] = buckets
        meta[label] = {"span": span, "busy": busy, "idle": span - busy,
                       "instrs": len(eids)}
    return StallReport(per_wg=per_wg, meta=meta, makespan=dag.makespan)


# ---------------------------------------------------------------------------
# stall timelines (the attribution above, resolved over cycle windows)
# ---------------------------------------------------------------------------

def _spread(acc: Dict[int, float], lo: int, hi: int, cycles: float,
            window: int) -> None:
    """Distribute ``cycles`` uniformly over the windows overlapped by
    ``[lo, hi)`` (float apportionment at the boundary windows)."""
    span = hi - lo
    if span <= 0 or cycles <= 0:
        return
    w = lo - lo % window
    while w < hi:
        seg = min(hi, w + window) - max(lo, w)
        if seg > 0:
            acc[w] = acc.get(w, 0.0) + cycles * seg / span
        w += window


def stall_timeline(dag: PipelineDAG, window: int = 256
                   ) -> Dict[str, Dict[str, Dict[int, float]]]:
    """Per-warpgroup stall buckets resolved over ``window``-cycle windows:
    ``label -> bucket -> {window_start: cycles}``.

    The same walk as :func:`attribute_stalls`, but each bucketed wait
    interval is spread over the windows it overlaps (uniformly within the
    interval; each bucket's windowed values sum to its attribution total).
    This is the PipeEvent-side counter timeline — the engine-sampled
    counters (``obs.counters``) cover bandwidths/occupancy, this covers
    *why lanes idled, when*."""
    out: Dict[str, Dict[str, Dict[int, float]]] = {}
    for label, eids in dag.threads.items():
        acc: Dict[str, Dict[int, float]] = {}
        for i, eid in enumerate(eids):
            if i == 0:
                continue
            e = dag.events[eid]
            prev_end = dag.events[eids[i - 1]].t1
            gap = e.t0 - prev_end
            if gap <= 0:
                continue
            wait = min(gap, max(0, dag.ready[eid] - prev_end))
            sched = gap - wait
            if wait:
                for k, v in _bucket_split(dag, eid, prev_end,
                                          prev_end + wait).items():
                    _spread(acc.setdefault(k, {}), prev_end,
                            prev_end + wait, v, window)
            if sched:
                _spread(acc.setdefault("scheduler", {}), prev_end + wait,
                        e.t0, sched, window)
        out[label] = acc
    return out
