"""Runtime hazard sanitizer + deadlock explainer (the dynamic half of the
kprog verifier, ``repro_torch.core.kprog.verify``).

Two duck-typed services over live engine state, both bit-neutral in the
PR-7 counter-sink sense — they only *read* simulated state (plus their own
private bookkeeping), never mutate it, so attaching them cannot change a
single simulated cycle:

  * :class:`HazardSanitizer` — ``Engine(sanitize=True)``.  A TSan-style
    per-event cross-check of the ring protocol invariants the static
    verifier proves over the lowered streams: every TMA refill of a ring
    stage is covered by a fresh ACQUIRE (unguarded-load / write-after-read
    race), every RELEASE closes a reader window that an MB_WAIT opened
    (release-without-wait), and windows still open at CTA retirement are
    leaked stages (wait-release-mismatch).  Cost is one ``is not None``
    test per issued instruction when disabled and a couple of dict
    operations on sync opcodes when enabled.
  * :func:`explain_deadlock` — called by the engine the moment a run loop
    concludes nothing can ever progress again.  Snapshots every blocked
    thread (opcode, sid/bid, need vs. have counts), reconstructs the
    inter-warpgroup wait-for graph from the threads' remaining streams,
    and extracts a minimal witness cycle — the dynamic analogue of the
    static verifier's deadlock finding, surfaced through
    ``SimResult.deadlock_info`` and the obs report instead of a bare
    ``deadlocked=True``.

Neither imports the engine (duck-typing keeps ``core`` -> ``analysis``
one-directional at module-import time).
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.core import isa

# codes mirror the static verifier's catalogue (docs/verification.md)
UNGUARDED_LOAD = "unguarded-load"
RELEASE_WITHOUT_WAIT = "release-without-wait"
WAIT_RELEASE_MISMATCH = "wait-release-mismatch"
RACE_WAR = "race-war"


@dataclass(frozen=True)
class HazardIssue:
    """One dynamic invariant violation, anchored to a simulated cycle."""
    cycle: int
    code: str
    cta: str           # CTA trace name
    wg: str            # thread label
    pc: int
    op: str
    detail: str

    def render(self) -> str:
        return (f"[cycle {self.cycle}] {self.code}: {self.cta}/{self.wg}"
                f"@{self.pc} {self.op} — {self.detail}")


class HazardSanitizer:
    """Per-event ring-protocol cross-check (``Engine(sanitize=True)``).

    State is keyed by CTA launch index and dropped at retirement, so
    memory stays bounded by residency, not launch size.  Issues are capped
    at ``max_issues`` (the total count keeps incrementing past the cap).
    """

    def __init__(self, max_issues: int = 256):
        self.issues: List[HazardIssue] = []
        self.n_issues = 0
        self.max_issues = max_issues
        # cta idx -> {sid: ring name}; None for CTAs without ring metadata
        self._rings: Dict[int, Optional[Dict[int, str]]] = {}
        self._armed: Dict[Tuple[int, int], int] = {}     # (cta, sid) -> pc
        # (cta, sid) -> {wg_id: open reader windows}
        self._windows: Dict[Tuple[int, int], Dict[int, int]] = {}

    # ------------------------------------------------------------------
    def _issue(self, cycle: int, th, pc: int, op: str, code: str,
               detail: str) -> None:
        self.n_issues += 1
        if len(self.issues) < self.max_issues:
            self.issues.append(HazardIssue(
                cycle, code, th.cta.trace.name, th.label, pc, op, detail))

    def _ring_map(self, cta) -> Optional[Dict[int, str]]:
        m = self._rings.get(cta.idx, -1)
        if m != -1:
            return m
        rings = getattr(cta.trace, "rings", None)
        m = None
        if rings:
            m = {}
            for name, sids in rings.items():
                for s in sids:
                    m[s] = name
        self._rings[cta.idx] = m
        return m

    # ------------------------------------------------------------------
    def on_execute(self, cycle: int, th, ins) -> None:
        """Hook at instruction issue (top of ``SM._execute``)."""
        rm = self._ring_map(th.cta)
        if rm is None or ins.sid not in rm:
            return
        key = (th.cta.idx, ins.sid)
        op = ins.op
        if op == isa.ACQUIRE_STAGE:
            if key in self._armed:
                self._issue(cycle, th, th.pc, op, WAIT_RELEASE_MISMATCH,
                            f"re-acquires sid {ins.sid} (ring "
                            f"{rm[ins.sid]!r}) while the acquire armed at "
                            f"pc {self._armed[key]} was never consumed by "
                            f"a load")
            self._armed[key] = th.pc
        elif op == isa.TMA_TENSOR:
            armed = self._armed.pop(key, None)
            readers = self._windows.get(key)
            if armed is None:
                code = RACE_WAR if readers else UNGUARDED_LOAD
                who = (f"; readers still in the stage: "
                       f"{sorted(readers)}" if readers else "")
                self._issue(cycle, th, th.pc, op, code,
                            f"refills sid {ins.sid} (ring {rm[ins.sid]!r}) "
                            f"without a covering ACQUIRE_STAGE{who}")
        elif op == isa.MB_WAIT:
            w = self._windows.setdefault(key, {})
            w[th.wg_id] = w.get(th.wg_id, 0) + 1
        elif op == isa.RELEASE_STAGE:
            w = self._windows.get(key)
            if not w or not w.get(th.wg_id):
                self._issue(cycle, th, th.pc, op, RELEASE_WITHOUT_WAIT,
                            f"releases sid {ins.sid} (ring {rm[ins.sid]!r}) "
                            f"without an open reader window (no prior "
                            f"MB_WAIT by this warpgroup)")
            else:
                w[th.wg_id] -= 1
                if not w[th.wg_id]:
                    del w[th.wg_id]

    def on_cta_retired(self, cycle: int, cta) -> None:
        """Windows still open at retirement are leaked ring stages."""
        rm = self._rings.pop(cta.idx, None)
        for key in [k for k in self._windows if k[0] == cta.idx]:
            w = self._windows.pop(key)
            leaked = {wg: n for wg, n in w.items() if n}
            if leaked and rm:
                th = cta.threads[min(leaked)]
                self._issue(cycle, th, -1, "", WAIT_RELEASE_MISMATCH,
                            f"CTA retired with {sum(leaked.values())} "
                            f"reader window(s) still open on sid {key[1]} "
                            f"(ring {rm.get(key[1])!r}): tiles were waited "
                            f"on but never released")
        for key in [k for k in self._armed if k[0] == cta.idx]:
            del self._armed[key]

    def render(self) -> str:
        head = f"sanitizer: {self.n_issues} issue(s)"
        if self.n_issues > len(self.issues):
            head += f" (showing first {len(self.issues)})"
        return "\n".join([head] + [i.render() for i in self.issues])


# ---------------------------------------------------------------------------
# deadlock explanation
# ---------------------------------------------------------------------------

def _need_have(th, ins) -> Tuple[str, int, int]:
    """(operand description, needed count, current count) for a blocking
    instruction, mirroring ``SM._cond_met``."""
    cta = th.cta
    op = ins.op
    if op == isa.MB_WAIT:
        return (f"sid {ins.sid}", th.mb_expected.get(ins.sid, 0) + 1,
                cta.mbarrier.get(ins.sid, 0))
    if op == isa.ACQUIRE_STAGE:
        use = th.acq_count.get(ins.sid, 0)
        return (f"sid {ins.sid}", use * cta.n_consumers,
                cta.stage_releases.get(ins.sid, 0))
    if op == isa.BAR_WAIT:
        return (f"bid {ins.bid}", ins.n, cta.bar_arrivals.get(ins.bid, 0))
    if op == isa.WGMMA_WAIT:
        return (f"gid {ins.gid} (<= {ins.n} outstanding)", ins.n,
                sum(1 for g in th.wgmma_out if g <= ins.gid))
    if op == isa.TMA_WAIT:
        return (f"gid {ins.gid} (<= {ins.n} outstanding)", ins.n,
                sum(1 for g in th.tma_out if g <= ins.gid))
    return ("", 0, 0)


def _providers(th, ins) -> List[str]:
    """Labels of same-CTA threads whose remaining stream contains an op
    that would advance ``th``'s blocked condition."""
    op = ins.op
    if op == isa.MB_WAIT:
        want, attr, val = isa.TMA_TENSOR, "sid", ins.sid
    elif op == isa.ACQUIRE_STAGE:
        want, attr, val = isa.RELEASE_STAGE, "sid", ins.sid
    elif op == isa.BAR_WAIT:
        want, attr, val = isa.BAR_ARRIVE, "bid", ins.bid
    else:
        return []
    out = []
    for other in th.cta.threads:
        start = other.pc + (1 if other is th else 0)
        if any(i.op == want and getattr(i, attr) == val
               for i in other.trace[start:]):
            out.append(other.label)
    return out


def _shortest_cycle_labels(
        edges: Dict[str, List[str]]) -> Optional[List[str]]:
    best: Optional[List[str]] = None
    for start in sorted(edges):
        prev: Dict[str, Optional[str]] = {start: None}
        q = deque([start])
        found: Optional[List[str]] = None
        while q and found is None:
            u = q.popleft()
            for v in edges.get(u, ()):
                if v == start:
                    path, node = [], u
                    while node is not None:
                        path.append(node)
                        node = prev[node]
                    found = list(reversed(path))
                    break
                if v not in prev:
                    prev[v] = u
                    q.append(v)
        if found is not None and (best is None or len(found) < len(best)):
            best = found
    return best


def explain_deadlock(engine) -> Dict[str, Any]:
    """Snapshot why a run loop concluded no progress is possible.

    Returns a JSON-serializable dict: ``cycle``, ``n_blocked``, per-thread
    ``blocked`` entries (label, CTA, sm, pc, opcode, operand, need/have,
    ``waits_on`` provider labels) and the minimal wait-for ``cycle_witness``
    (list of labels) when a circular wait exists among resident threads.
    Read-only over engine state — safe to call from the deadlocked loops.
    """
    blocked: List[Dict[str, Any]] = []
    edges: Dict[str, List[str]] = {}
    for sm in engine.sms:
        for th in sm.threads():
            if th.done():
                continue
            ins = th.trace[th.pc]
            operand, need, have = _need_have(th, ins)
            providers = _providers(th, ins)
            blocked.append({
                "label": th.label,
                "cta": th.cta.trace.name,
                "sm": sm.sm_id,
                "pc": th.pc,
                "op": ins.op,
                "operand": operand,
                "need": need,
                "have": have,
                "waits_on": providers,
            })
            if providers:
                edges[th.label] = providers
    witness = _shortest_cycle_labels(edges) if edges else None
    return {
        "cycle": engine.cycle,
        "n_blocked": len(blocked),
        "launched": engine.launched,
        "retired": engine.retired,
        "blocked": blocked,
        "cycle_witness": witness,
    }


def render_deadlock(info: Dict[str, Any], limit: int = 8) -> List[str]:
    """Human-readable lines for a deadlock-info dict (obs report)."""
    lines = [f"  deadlock at cycle {info['cycle']}: {info['n_blocked']} "
             f"thread(s) blocked, {info['retired']}/{info['launched']} "
             f"CTAs retired"]
    if info.get("cycle_witness"):
        lines.append("    circular wait: "
                     + " -> ".join(info["cycle_witness"]
                                   + info["cycle_witness"][:1]))
    for b in info["blocked"][:limit]:
        lines.append(f"    {b['label']}@{b['pc']} {b['op']} {b['operand']}"
                     f" (need {b['need']}, have {b['have']})"
                     + (f" <- {', '.join(b['waits_on'])}"
                        if b["waits_on"] else " <- nothing pending"))
    if len(info["blocked"]) > limit:
        lines.append(f"    ... and {len(info['blocked']) - limit} more")
    return lines
