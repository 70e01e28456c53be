"""Typed pipeline events with causal metadata (the trace the DAG is built on).

The cycle engine used to emit flat ``(tag, start, end)`` gantt tuples — enough
to draw Fig. 7, useless for asking *why* a warpgroup stalled.  A
:class:`PipeEvent` instead records, for every executed instruction and every
async engine operation, the operands and *ordinal* information needed to
reconstruct the causal edges afterwards:

  * an mbarrier wait records which signal count it required (``dep_n``), and
    every TMA load records which signal ordinal it produced — matching the two
    gives the exact ``signal -> wait`` edge;
  * ``producer_acquire`` records the release ordinal it blocked on,
    ``consumer_release`` its own ordinal;
  * WGMMA/TMA drain waits record the highest group id that had to complete;
  * async engine events (``mma``, ``tma``) record the lane event that issued
    them (``src``) so issue->execute edges are explicit.

Event kinds
  ``issue``  — one instruction leaving the warpgroup's instruction stream;
               occupies the lane for zero cycles (``t0 == t1``).
  ``bubble`` — a CUDA-core block (softmax etc.); occupies ``[t0, t1)``.
  ``mma``    — one WGMMA executing on the SM tensor-core pipeline.
  ``tma``    — one TMA load/store job (submit at ``t0``, last line at ``t1``;
               ``fixed`` = descriptor/launch setup cycles, the non-bandwidth
               portion a what-if must not scale).

``t_done`` is when the event's *effect* lands (mbarrier signal time, WGMMA
group completion, ...); for synchronous lane events ``t_done == t1``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

from repro_torch.core import isa

# event kinds
ISSUE, BUBBLE, MMA, TMA = "issue", "bubble", "mma", "tma"

# ops carried by engine-side events
TMA_LOAD_JOB = "TMA_LOAD_JOB"
TMA_STORE_JOB = "TMA_STORE_JOB"
WGMMA_EXEC = "WGMMA_EXEC"


@dataclass
class PipeEvent:
    eid: int
    kind: str                  # issue | bubble | mma | tma
    op: str                    # isa opcode or engine-op constant above
    sm: int
    cta: int                   # global CTA launch index
    wg: int                    # warpgroup id within the CTA
    label: str                 # "cta{idx}/{role}", e.g. "cta0/consumer1"
                               # ("cta{idx}/wg{id}" for role-less traces)
    tag: str = ""
    t0: int = 0                # start (issue cycle / engine start)
    t1: int = 0                # end of lane/engine occupancy
    t_done: int = 0            # effect completion time
    sid: int = -1
    gid: int = -1
    bid: int = -1
    dep_n: int = 0             # wait: required ordinal; signal: own ordinal
    fixed: int = 0             # non-scalable cycles (TMA setup)
    src: int = -1              # issuing lane event (engine events only)

    @property
    def dur(self) -> int:
        return self.t1 - self.t0


class EventTracer:
    """Engine hook sink: builds the :class:`PipeEvent` list during a run.

    The tracer is deliberately dumb — it snapshots counters at well-defined
    points (before ``_apply_blocking``/``_execute`` mutate them for lane
    events, after the mbarrier increment for TMA completions) and leaves all
    graph construction to :mod:`repro_torch.analysis.dag`.  Event ids are a valid
    topological order of the eventual DAG: every event is created after all
    of its predecessors.

    Contract with the engine's waiter-indexed scheduler: parking/waking
    threads must never change *when* an instruction issues, only how the
    engine finds it — so the ordinal snapshots here (``dep_n``, signal
    counts) stay bit-identical between the waiter and broadcast schedulers
    (enforced by ``tests/test_engine_equiv.py``).  Within one cycle, events
    from different SMs are ordered by ascending SM id — the engine pins
    that order deterministically; it is the one place the trace may differ
    from pre-PR-4 runs, which inherited CPython set-iteration order.
    """

    def __init__(self):
        self.events: List[PipeEvent] = []
        # child cta idx -> parent cta idx whose retirement freed the slot
        self.dispatch_parent: Dict[int, int] = {}

    # ------------------------------------------------------------------
    def _new(self, **kw) -> PipeEvent:
        ev = PipeEvent(eid=len(self.events), **kw)
        self.events.append(ev)
        return ev

    # ------------------------------------------------------------------
    def on_issue(self, cycle: int, th, ins) -> int:
        """One instruction issued by warpgroup thread ``th``.

        Must run *before* the engine's ``_apply_blocking``/``_execute`` so the
        counter snapshots below still reflect the pre-issue state.
        """
        cta = th.cta
        op = ins.op
        kind = ISSUE
        t1 = t_done = cycle
        dep_n = 0
        if op == isa.MB_WAIT:
            dep_n = th.mb_expected.get(ins.sid, 0) + 1       # signal we needed
        elif op == isa.ACQUIRE_STAGE:
            use = th.acq_count.get(ins.sid, 0)
            dep_n = use * cta.n_consumers                    # release ordinal
        elif op == isa.RELEASE_STAGE:
            dep_n = cta.stage_releases.get(ins.sid, 0) + 1   # own ordinal
        elif op == isa.BAR_ARRIVE:
            dep_n = cta.bar_arrivals.get(ins.bid, 0) + 1     # own ordinal
        elif op == isa.BAR_WAIT:
            dep_n = ins.n                                    # arrival ordinal
        elif op in (isa.WGMMA_WAIT, isa.TMA_WAIT):
            dep_n = ins.gid - ins.n                          # drain threshold
        elif op == isa.BUBBLES:
            kind = BUBBLE
            t1 = t_done = cycle + ins.cycles
        ev = self._new(kind=kind, op=op, sm=th.sm.sm_id, cta=cta.idx,
                       wg=th.wg_id, label=th.label, tag=ins.tag, t0=cycle,
                       t1=t1, t_done=t_done, sid=ins.sid, gid=ins.gid,
                       bid=ins.bid, dep_n=dep_n)
        return ev.eid

    def on_mma(self, src_eid: int, th, ins, start: int, end: int) -> int:
        ev = self._new(kind=MMA, op=WGMMA_EXEC, sm=th.sm.sm_id,
                       cta=th.cta.idx, wg=th.wg_id, label=th.label,
                       tag=ins.tag, t0=start, t1=end, t_done=end,
                       gid=ins.gid, src=src_eid)
        return ev.eid

    def on_tma(self, src_eid: int, th, *, write: bool, tag: str, t0: int,
               t1: int, fixed: int, sid: int = -1, gid: int = -1,
               signal_n: int = 0) -> int:
        """One finished TMA job.  For loads ``signal_n`` is the mbarrier
        signal ordinal this completion produced on ``(cta, sid)``."""
        ev = self._new(kind=TMA, op=TMA_STORE_JOB if write else TMA_LOAD_JOB,
                       sm=th.sm.sm_id, cta=th.cta.idx, wg=th.wg_id,
                       label=th.label, tag=tag, t0=t0, t1=t1, t_done=t1,
                       sid=sid, gid=gid, dep_n=signal_n, fixed=fixed,
                       src=src_eid)
        return ev.eid

    def on_dispatch(self, child_cta: int, parent_cta: Optional[int]):
        if parent_cta is not None:
            self.dispatch_parent[child_cta] = parent_cta

    # ------------------------------------------------------------------
    def __len__(self):
        return len(self.events)
