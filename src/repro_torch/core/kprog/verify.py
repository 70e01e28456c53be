"""Static verifier for lowered kernel programs (the kprog legality oracle).

A :class:`~repro_torch.core.kprog.ir.KernelSpec` that drops a ``release()``,
waits on a token before anything signals it, or over-subscribes a ring
used to surface only as the engine silently timing out into a bare
``deadlocked=True``.  This module decides legality *statically*, in
microseconds, from the lowered :class:`~repro_torch.core.engine.CTATrace`
per-warpgroup instruction streams plus the IR's ring/token/barrier
metadata riders (``CTATrace.rings`` / ``tokens`` / ``acq_slots``) — the
oracle every registry kernel passes through at resolve time
(``registry.get``) and the pruning filter an autotuner needs to reject
illegal (roles, ring-depth, token-topology) candidates without simulating
each one into a deadlock.

Three checker families (catalogue in docs/verification.md):

  * **deadlock freedom** — an abstract concurrent execution of the CTA's
    warpgroups under maximal progress: async ops complete instantly (their
    completion is guaranteed in finite simulated time), so the only
    blocking conditions are the cross-warpgroup ones — mbarrier waits,
    ring ACQUIRE counting, named-barrier thresholds.  Because every engine
    condition is a monotone counter, the abstract execution quiesces at
    the counters' least fixed point: it completes **iff** the engine
    terminates.  On quiescence with live warpgroups, provider-less waits
    become ``unsatisfiable-wait`` findings and the remaining wait-for
    graph yields a minimal (BFS-shortest) witness cycle.
  * **protocol discipline** — per-warpgroup linear scans: every MB_WAIT
    has a reaching signaler (wait count vs. CTA-wide signal count per
    sid), ACQUIRE/load alternation per ring sid, wait/release pairing per
    consumer, WGMMA commit-group wait ≤ outstanding, TMA
    store → commit → wait ordering.
  * **hazards** — ring over-subscription (live acquires beyond ``stages``,
    with pre-wrap slot numbers as the aliasing witness), sid-space
    collisions between ring sids and the ``Q_READY_SID`` token range, and
    write-after-read races (a ring slot refilled or released out from
    under a reader: more releasing warpgroups than ``n_consumers``,
    releases without a matching wait).

The dynamic half — the same invariants cross-checked per event inside a
running engine — lives in :mod:`repro_torch.analysis.hazards`
(``Engine(sanitize=True)``).
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.core import isa
from repro_torch.core.isa import Instr

ERROR = "error"
WARNING = "warning"

# finding codes (the checker catalogue)
DEADLOCK = "deadlock"
UNSATISFIABLE_WAIT = "unsatisfiable-wait"
BARRIER_UNDERFLOW = "barrier-underflow"
RING_OVERSUBSCRIPTION = "ring-oversubscription"
SID_COLLISION = "sid-collision"
UNGUARDED_LOAD = "unguarded-load"
RELEASE_WITHOUT_WAIT = "release-without-wait"
WAIT_RELEASE_MISMATCH = "wait-release-mismatch"
CONSUMER_MISMATCH = "consumer-mismatch"
COMMIT_PROTOCOL = "commit-protocol"

_BLOCKING_OPS = (isa.MB_WAIT, isa.ACQUIRE_STAGE, isa.BAR_WAIT)


@dataclass(frozen=True)
class Finding:
    """One verifier observation, anchored to a (CTA, warpgroup, pc)."""
    severity: str              # "error" | "warning"
    code: str                  # catalogue code, e.g. "deadlock"
    cta: str                   # CTA name ("" when unknown)
    wg: str                    # warpgroup role label ("" for CTA-wide)
    pc: int                    # instruction index (-1 for CTA-wide)
    op: str                    # opcode at pc ("" for CTA-wide)
    detail: str                # human-readable explanation
    witness: Tuple[str, ...] = ()   # e.g. the wait-for cycle, hop by hop

    def render(self) -> str:
        where = self.cta
        if self.wg:
            where += f"/{self.wg}"
        if self.pc >= 0:
            where += f"@{self.pc}"
        head = (f"[{self.severity.upper():7s}] {self.code:22s} {where}"
                + (f" {self.op}" if self.op else ""))
        lines = [head, f"    {self.detail}"]
        for hop in self.witness:
            lines.append(f"      | {hop}")
        return "\n".join(lines)


@dataclass
class VerifyReport:
    """Structured verdict for one lowered launch (or one CTA)."""
    kernel: str
    n_ctas: int = 0            # CTAs covered (incl. shape-deduplicated)
    n_unique: int = 0          # distinct CTA shapes actually verified
    findings: List[Finding] = field(default_factory=list)

    @property
    def errors(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == ERROR]

    @property
    def warnings(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == WARNING]

    @property
    def ok(self) -> bool:
        return not self.errors

    def codes(self) -> Set[str]:
        return {f.code for f in self.findings}

    def render(self) -> str:
        verdict = "OK" if self.ok else "ILLEGAL"
        head = (f"verify {self.kernel}: {verdict} — {self.n_ctas} CTAs "
                f"({self.n_unique} unique shapes), "
                f"{len(self.errors)} errors, {len(self.warnings)} warnings")
        return "\n".join([head] + [f.render() for f in self.findings])


class KernelVerificationError(ValueError):
    """Raised by resolve-time verification when a spec is illegal."""

    def __init__(self, report: VerifyReport):
        self.report = report
        super().__init__(f"kernel {report.kernel!r} failed static "
                         f"verification:\n{report.render()}")


# ---------------------------------------------------------------------------
# CTA metadata view
# ---------------------------------------------------------------------------

class _Meta:
    """Resolved IR metadata for one CTATrace (all fields optional on
    hand-built traces — checks that need absent metadata are skipped)."""

    def __init__(self, trace):
        self.rings: Dict[str, Tuple[int, ...]] = dict(
            getattr(trace, "rings", None) or {})
        self.tokens: Dict[str, int] = dict(
            getattr(trace, "tokens", None) or {})
        self.acq_slots: List[Dict[int, Tuple[str, int]]] = list(
            getattr(trace, "acq_slots", None) or [])
        self.ring_of_sid: Dict[int, str] = {}
        for name, sids in self.rings.items():
            for s in sids:
                # collisions between rings are reported by _check_sid_spaces;
                # keep the first owner for the protocol scans
                self.ring_of_sid.setdefault(s, name)
        self.token_sids: Set[int] = set(self.tokens.values())
        self.token_of_sid = {s: n for n, s in self.tokens.items()}
        roles = getattr(trace, "roles", None)
        self.labels = [roles[i] if roles and i < len(roles) else f"wg{i}"
                       for i in range(len(trace.wgs))]

    def stages(self, ring: str) -> int:
        return len(self.rings.get(ring, ()))

    def sid_desc(self, sid: int) -> str:
        if sid in self.ring_of_sid:
            return f"sid {sid} (ring {self.ring_of_sid[sid]!r})"
        if sid in self.token_of_sid:
            return f"sid {sid} (token {self.token_of_sid[sid]!r})"
        return f"sid {sid}"


def _operand_desc(meta: _Meta, ins: Instr) -> str:
    if ins.op in (isa.BAR_WAIT, isa.BAR_ARRIVE):
        return f"bid {ins.bid} (n>={ins.n})" if ins.op == isa.BAR_WAIT \
            else f"bid {ins.bid}"
    if ins.sid >= 0:
        return meta.sid_desc(ins.sid)
    if ins.gid >= 0:
        return f"gid {ins.gid}"
    return ""


# ---------------------------------------------------------------------------
# checker family 1: sid-space collisions
# ---------------------------------------------------------------------------

def _check_sid_spaces(trace, meta: _Meta) -> List[Finding]:
    out: List[Finding] = []
    name = getattr(trace, "name", "")
    seen: Dict[int, str] = {}
    for ring, sids in sorted(meta.rings.items()):
        for s in sids:
            if s >= isa.Q_READY_SID:
                out.append(Finding(
                    ERROR, SID_COLLISION, name, "", -1, "",
                    f"ring {ring!r} stage sid {s} lies in the "
                    f"point-to-point token range (>= Q_READY_SID="
                    f"{isa.Q_READY_SID}); ring and token signals on one "
                    f"mbarrier cannot be told apart",
                    witness=(f"ring {ring} sids: {sids}",)))
            owner = seen.get(s)
            if owner is not None and owner != ring:
                out.append(Finding(
                    ERROR, SID_COLLISION, name, "", -1, "",
                    f"rings {owner!r} and {ring!r} share stage sid {s}: "
                    f"their pipelines release into each other's slots",
                    witness=(f"{owner}: {meta.rings[owner]}",
                             f"{ring}: {sids}")))
            seen.setdefault(s, ring)
    for tok, s in sorted(meta.tokens.items()):
        if s < isa.Q_READY_SID:
            out.append(Finding(
                ERROR, SID_COLLISION, name, "", -1, "",
                f"token {tok!r} sid {s} lies in the ring stage range "
                f"(< Q_READY_SID={isa.Q_READY_SID})"))
        if s in meta.ring_of_sid:
            out.append(Finding(
                ERROR, SID_COLLISION, name, "", -1, "",
                f"token {tok!r} aliases ring {meta.ring_of_sid[s]!r} "
                f"stage sid {s}: a tile arrival would satisfy the token "
                f"wait (and vice versa)"))
    return out


# ---------------------------------------------------------------------------
# checker family 2: per-warpgroup protocol scans
# ---------------------------------------------------------------------------

def _check_wg_protocol(trace, meta: _Meta, wi: int,
                       instrs: Sequence[Instr]) -> List[Finding]:
    out: List[Finding] = []
    name = getattr(trace, "name", "")
    wg = meta.labels[wi]
    armed: Dict[int, int] = {}          # ring sid -> pc of pending acquire
    waits: Dict[int, int] = {}          # ring sid -> MB_WAIT count
    releases: Dict[int, int] = {}       # ring sid -> RELEASE count
    live_by_ring: Dict[str, List[int]] = {}   # ring -> pcs of live acquires
    max_live: Dict[str, Tuple[int, List[int]]] = {}
    self_releases: Set[str] = {
        meta.ring_of_sid[i.sid] for i in instrs
        if i.op == isa.RELEASE_STAGE and i.sid in meta.ring_of_sid}
    wg_slots = meta.acq_slots[wi] if wi < len(meta.acq_slots) else {}
    # WGMMA commit groups: gid -> [n_issued, committed]
    wgmma: Dict[int, List] = {}
    # TMA store groups: gid -> [n_stores, committed, awaited]
    stores: Dict[int, List] = {}

    for pc, ins in enumerate(instrs):
        op = ins.op
        if op == isa.ACQUIRE_STAGE:
            ring = meta.ring_of_sid.get(ins.sid)
            if ring is None:
                continue
            if ins.sid in armed:
                out.append(Finding(
                    WARNING, COMMIT_PROTOCOL, name, wg, pc, op,
                    f"re-acquires {meta.sid_desc(ins.sid)} while the "
                    f"acquire at pc {armed[ins.sid]} has not been used by "
                    f"a load"))
            armed[ins.sid] = pc
            # self-releasing rings: track live (acquired, unreleased) depth
            if ring in self_releases:
                live = live_by_ring.setdefault(ring, [])
                live.append(pc)
                best = max_live.get(ring, (0, []))
                if len(live) > best[0]:
                    max_live[ring] = (len(live), list(live))
        elif op == isa.TMA_TENSOR:
            ring = meta.ring_of_sid.get(ins.sid)
            if ring is not None:
                if ins.sid in armed:
                    del armed[ins.sid]
                else:
                    out.append(Finding(
                        ERROR, UNGUARDED_LOAD, name, wg, pc, op,
                        f"TMA load into {meta.sid_desc(ins.sid)} without a "
                        f"preceding ACQUIRE_STAGE: the producer can refill "
                        f"the slot while a consumer still reads it "
                        f"(write-after-read race)"))
        elif op == isa.MB_WAIT:
            if ins.sid in meta.ring_of_sid:
                waits[ins.sid] = waits.get(ins.sid, 0) + 1
        elif op == isa.RELEASE_STAGE:
            ring = meta.ring_of_sid.get(ins.sid)
            if ring is None:
                continue
            releases[ins.sid] = releases.get(ins.sid, 0) + 1
            if releases[ins.sid] > waits.get(ins.sid, 0):
                out.append(Finding(
                    ERROR, RELEASE_WITHOUT_WAIT, name, wg, pc, op,
                    f"releases {meta.sid_desc(ins.sid)} more often than it "
                    f"has waited on it ({releases[ins.sid]} releases vs "
                    f"{waits.get(ins.sid, 0)} waits so far): the release "
                    f"un-gates the producer while another consumer may "
                    f"still be reading the stage"))
            if ring in live_by_ring and live_by_ring[ring]:
                live_by_ring[ring].pop(0)
        elif op == isa.WGMMA:
            g = wgmma.setdefault(ins.gid, [0, False])
            g[0] += 1
            if g[1]:
                out.append(Finding(
                    WARNING, COMMIT_PROTOCOL, name, wg, pc, op,
                    f"WGMMA issued into gid {ins.gid} after its commit: "
                    f"the group id is being reused"))
        elif op == isa.WGMMA_COMMIT:
            g = wgmma.setdefault(ins.gid, [0, False])
            if g[0] == 0:
                out.append(Finding(
                    WARNING, COMMIT_PROTOCOL, name, wg, pc, op,
                    f"commits empty WGMMA group gid {ins.gid}"))
            g[1] = True
        elif op == isa.WGMMA_WAIT:
            committed = sorted(g for g, st in wgmma.items()
                               if st[1] and g <= ins.gid)
            if ins.gid not in wgmma or not wgmma[ins.gid][1]:
                out.append(Finding(
                    WARNING, COMMIT_PROTOCOL, name, wg, pc, op,
                    f"waits on WGMMA group gid {ins.gid} that was never "
                    f"committed in this warpgroup: the drain is a no-op"))
            elif ins.n > len(committed):
                out.append(Finding(
                    WARNING, COMMIT_PROTOCOL, name, wg, pc, op,
                    f"waits for <= {ins.n} outstanding groups but only "
                    f"{len(committed)} groups (ids <= {ins.gid}) were ever "
                    f"committed: wait exceeds the possible outstanding "
                    f"count and never gates anything"))
        elif op == isa.TMA_STORE:
            g = stores.setdefault(ins.gid, [0, False, False])
            g[0] += 1
            if g[1]:
                out.append(Finding(
                    WARNING, COMMIT_PROTOCOL, name, wg, pc, op,
                    f"TMA store issued into gid {ins.gid} after its "
                    f"commit"))
        elif op == isa.TMA_COMMIT:
            stores.setdefault(ins.gid, [0, False, False])[1] = True
        elif op == isa.TMA_WAIT:
            covered = False
            for gid, g in stores.items():
                if gid <= ins.gid and g[1]:
                    g[2] = True
                    covered = True
            if not covered and stores:
                out.append(Finding(
                    WARNING, COMMIT_PROTOCOL, name, wg, pc, op,
                    f"TMA_WAIT on gid {ins.gid} covers no committed store "
                    f"group (store -> commit -> wait ordering broken)"))

    for sid, n_armed_pc in sorted(armed.items()):
        out.append(Finding(
            WARNING, COMMIT_PROTOCOL, name, wg, n_armed_pc,
            isa.ACQUIRE_STAGE,
            f"acquire of {meta.sid_desc(sid)} is never followed by a load"))
    for sid in sorted(set(waits) | set(releases)):
        w, r = waits.get(sid, 0), releases.get(sid, 0)
        if w > r:
            out.append(Finding(
                WARNING, WAIT_RELEASE_MISMATCH, name, wg, -1, "",
                f"waits on {meta.sid_desc(sid)} {w} times but releases it "
                f"only {r} times: the producer's ACQUIRE accounting comes "
                f"up short (a dropped release deadlocks once the ring "
                f"wraps; the final-tile case merely leaks the stage)"))
    for gid, g in sorted(stores.items()):
        if g[0] and not g[1]:
            out.append(Finding(
                WARNING, COMMIT_PROTOCOL, name, wg, -1, "",
                f"TMA store group gid {gid} is never committed: its drain "
                f"waits are no-ops and the stored bytes may still be in "
                f"flight at warpgroup retirement"))
        elif g[0] and not g[2]:
            out.append(Finding(
                WARNING, COMMIT_PROTOCOL, name, wg, -1, "",
                f"TMA store group gid {gid} is committed but never "
                f"awaited: the warpgroup can retire with the store in "
                f"flight"))
    for gid, g in sorted(wgmma.items()):
        if g[0] and not g[1]:
            out.append(Finding(
                WARNING, COMMIT_PROTOCOL, name, wg, -1, "",
                f"WGMMA group gid {gid} is never committed: no drain wait "
                f"can cover it"))

    for ring, (depth, pcs) in sorted(max_live.items()):
        stages = meta.stages(ring)
        if stages and depth > stages:
            slots = [wg_slots.get(p, (ring, -1))[1] for p in pcs]
            aliased = [
                (a, b) for i, a in enumerate(slots) for b in slots[i + 1:]
                if a >= 0 and b >= 0 and a != b
                and a % stages == b % stages]
            pair = aliased[0] if aliased else None
            out.append(Finding(
                ERROR, RING_OVERSUBSCRIPTION, name, wg, pcs[-1],
                isa.ACQUIRE_STAGE,
                f"holds {depth} live acquires on ring {ring!r} with only "
                f"{stages} stages before releasing any"
                + (f": distinct live slots {pair[0]} and {pair[1]} alias "
                   f"the same sid (slot % stages wrap)" if pair else ""),
                witness=tuple(f"acquire at pc {p} "
                              f"(slot {wg_slots.get(p, ('?', '?'))[1]})"
                              for p in pcs)))
    return out


# ---------------------------------------------------------------------------
# checker family 3: CTA-wide count checks
# ---------------------------------------------------------------------------

def _check_counts(trace, meta: _Meta) -> List[Finding]:
    out: List[Finding] = []
    name = getattr(trace, "name", "")
    signals: Dict[int, int] = {}
    arrivals: Dict[int, int] = {}
    for instrs in trace.wgs:
        for ins in instrs:
            if ins.op == isa.TMA_TENSOR:
                signals[ins.sid] = signals.get(ins.sid, 0) + 1
            elif ins.op == isa.BAR_ARRIVE:
                arrivals[ins.bid] = arrivals.get(ins.bid, 0) + 1

    for wi, instrs in enumerate(trace.wgs):
        waits: Dict[int, int] = {}
        for pc, ins in enumerate(instrs):
            if ins.op == isa.MB_WAIT:
                waits[ins.sid] = waits.get(ins.sid, 0) + 1
                if waits[ins.sid] == signals.get(ins.sid, 0) + 1:
                    out.append(Finding(
                        ERROR, UNSATISFIABLE_WAIT, name, meta.labels[wi],
                        pc, ins.op,
                        f"wait #{waits[ins.sid]} on "
                        f"{meta.sid_desc(ins.sid)} has no reaching "
                        f"signaler: the whole CTA only ever signals it "
                        f"{signals.get(ins.sid, 0)} times"))
            elif ins.op == isa.BAR_WAIT:
                if ins.n > arrivals.get(ins.bid, 0):
                    out.append(Finding(
                        ERROR, BARRIER_UNDERFLOW, name, meta.labels[wi],
                        pc, ins.op,
                        f"waits for >= {ins.n} arrivals on named barrier "
                        f"bid {ins.bid} but the CTA only ever arrives "
                        f"{arrivals.get(ins.bid, 0)} times"))

    # ring consumer cardinality: the ACQUIRE protocol divides the release
    # count by n_consumers, so the set of releasing warpgroups must match
    for ring, sids in sorted(meta.rings.items()):
        sid_set = set(sids)
        releasers = [meta.labels[wi] for wi, instrs in enumerate(trace.wgs)
                     if any(i.op == isa.RELEASE_STAGE and i.sid in sid_set
                            for i in instrs)]
        used = any(i.op == isa.MB_WAIT and i.sid in sid_set
                   for instrs in trace.wgs for i in instrs)
        n_cons = trace.n_consumers
        if len(releasers) > n_cons:
            out.append(Finding(
                ERROR, CONSUMER_MISMATCH, name, "", -1, "",
                f"ring {ring!r} is released by {len(releasers)} warpgroups "
                f"({', '.join(releasers)}) but the CTA declares "
                f"n_consumers={n_cons}: the producer's ACQUIRE un-gates "
                f"after only {n_cons} releases, refilling a stage other "
                f"consumers still read"))
        elif releasers and len(releasers) < n_cons and used:
            out.append(Finding(
                WARNING, CONSUMER_MISMATCH, name, "", -1, "",
                f"ring {ring!r} is released by only {len(releasers)} of "
                f"the declared n_consumers={n_cons} warpgroups: ACQUIRE "
                f"accounting can never reach its threshold once the ring "
                f"wraps"))
    return out


# ---------------------------------------------------------------------------
# checker family 4: abstract concurrent execution (deadlock freedom)
# ---------------------------------------------------------------------------

class _AbstractCTA:
    """Maximal-progress execution of one CTA's warpgroups with instant
    async completion.  All engine wait conditions are monotone counters, so
    the quiescent point is unique — this completes iff the engine does."""

    def __init__(self, trace, meta: _Meta):
        self.trace = trace
        self.meta = meta
        self.n_wgs = len(trace.wgs)
        self.pcs = [0] * self.n_wgs
        self.mbar: Dict[int, int] = {}
        self.releases: Dict[int, int] = {}
        self.arrivals: Dict[int, int] = {}
        self.mb_expected = [dict() for _ in range(self.n_wgs)]
        self.acq_count = [dict() for _ in range(self.n_wgs)]
        self.n_consumers = trace.n_consumers

    def _satisfiable(self, wi: int, ins: Instr) -> bool:
        op = ins.op
        if op == isa.MB_WAIT:
            need = self.mb_expected[wi].get(ins.sid, 0) + 1
            return self.mbar.get(ins.sid, 0) >= need
        if op == isa.ACQUIRE_STAGE:
            use = self.acq_count[wi].get(ins.sid, 0)
            if use == 0:
                return True
            return self.releases.get(ins.sid, 0) >= use * self.n_consumers
        if op == isa.BAR_WAIT:
            return self.arrivals.get(ins.bid, 0) >= ins.n
        return True          # WGMMA/TMA groups: async completion is instant

    def _advance(self, wi: int) -> bool:
        instrs = self.trace.wgs[wi]
        progressed = False
        while self.pcs[wi] < len(instrs):
            ins = instrs[self.pcs[wi]]
            if ins.op in _BLOCKING_OPS and not self._satisfiable(wi, ins):
                return progressed
            op = ins.op
            if op == isa.MB_WAIT:
                d = self.mb_expected[wi]
                d[ins.sid] = d.get(ins.sid, 0) + 1
            elif op == isa.ACQUIRE_STAGE:
                d = self.acq_count[wi]
                d[ins.sid] = d.get(ins.sid, 0) + 1
            elif op == isa.TMA_TENSOR:
                self.mbar[ins.sid] = self.mbar.get(ins.sid, 0) + 1
            elif op == isa.RELEASE_STAGE:
                self.releases[ins.sid] = self.releases.get(ins.sid, 0) + 1
            elif op == isa.BAR_ARRIVE:
                self.arrivals[ins.bid] = self.arrivals.get(ins.bid, 0) + 1
            self.pcs[wi] += 1
            progressed = True
        return progressed

    def run(self) -> List[int]:
        """Execute to quiescence; return the indices of blocked WGs."""
        progressed = True
        while progressed:
            progressed = False
            for wi in range(self.n_wgs):
                if self._advance(wi):
                    progressed = True
        return [wi for wi in range(self.n_wgs)
                if self.pcs[wi] < len(self.trace.wgs[wi])]

    # -- post-quiescence analysis --------------------------------------
    def _providers(self, wi: int) -> List[int]:
        """Blocked WGs whose remaining stream contains an op that would
        advance ``wi``'s unsatisfied condition (done WGs never qualify —
        their remaining stream is empty)."""
        ins = self.trace.wgs[wi][self.pcs[wi]]
        if ins.op == isa.MB_WAIT:
            match = (isa.TMA_TENSOR, "sid", ins.sid)
        elif ins.op == isa.ACQUIRE_STAGE:
            match = (isa.RELEASE_STAGE, "sid", ins.sid)
        else:
            match = (isa.BAR_ARRIVE, "bid", ins.bid)
        op, attr, val = match
        out = []
        for wj in range(self.n_wgs):
            start = self.pcs[wj] + (1 if wj == wi else 0)
            if any(i.op == op and getattr(i, attr) == val
                   for i in self.trace.wgs[wj][start:]):
                out.append(wj)
        return out

    def _live_holds(self, wi: int, ring: str) -> int:
        """Acquires by ``wi`` on ``ring`` not yet retired by releases."""
        held = 0
        for sid in self.meta.rings.get(ring, ()):
            acq = self.acq_count[wi].get(sid, 0)
            retired = min(acq, self.releases.get(sid, 0) // self.n_consumers)
            held += acq - retired
        return held

    def _blocked_desc(self, wi: int) -> str:
        pc = self.pcs[wi]
        ins = self.trace.wgs[wi][pc]
        return (f"{self.meta.labels[wi]} blocked at pc {pc} on {ins.op} "
                f"{_operand_desc(self.meta, ins)}")

    def diagnose(self, blocked: List[int]) -> List[Finding]:
        meta = self.meta
        name = getattr(self.trace, "name", "")
        out: List[Finding] = []
        edges: Dict[int, List[int]] = {}
        for wi in blocked:
            pc = self.pcs[wi]
            ins = self.trace.wgs[wi][pc]
            providers = self._providers(wi)
            if not providers:
                if ins.op == isa.BAR_WAIT:
                    code, extra = BARRIER_UNDERFLOW, \
                        "no remaining BAR_ARRIVE can raise the count"
                elif ins.op == isa.ACQUIRE_STAGE:
                    ring = meta.ring_of_sid.get(ins.sid)
                    stages = meta.stages(ring) if ring else 0
                    if ring and self._live_holds(wi, ring) >= stages > 0:
                        code = RING_OVERSUBSCRIPTION
                        extra = (f"all {stages} stages of ring {ring!r} are "
                                 f"held and nothing will release them")
                    else:
                        code, extra = UNSATISFIABLE_WAIT, \
                            "no remaining RELEASE_STAGE feeds this acquire"
                else:
                    code, extra = UNSATISFIABLE_WAIT, \
                        "no remaining signaler for this mbarrier"
                out.append(Finding(
                    ERROR, code, name, meta.labels[wi], pc, ins.op,
                    f"{self._blocked_desc(wi)}: {extra}",
                    witness=tuple(self._blocked_desc(w) for w in blocked)))
            else:
                edges[wi] = providers
        if out or not edges:
            return out
        cycle = _shortest_cycle(edges)
        if cycle is None:        # defensive: quiescence + providers => cycle
            cycle = sorted(edges)
        hops = []
        for i, wi in enumerate(cycle):
            nxt = cycle[(i + 1) % len(cycle)]
            hops.append(f"{self._blocked_desc(wi)} "
                        f"-> provided by {meta.labels[nxt]}")
        head = self.trace.wgs[cycle[0]][self.pcs[cycle[0]]]
        # classify: a circular wait whose head is a full-ring acquire is the
        # over-subscription shape (producer ran ahead of every release)
        ring = meta.ring_of_sid.get(head.sid) \
            if head.op == isa.ACQUIRE_STAGE else None
        code = DEADLOCK
        if ring and self._live_holds(cycle[0], ring) >= meta.stages(ring) > 0:
            code = RING_OVERSUBSCRIPTION
        out.append(Finding(
            ERROR, code, name, meta.labels[cycle[0]], self.pcs[cycle[0]],
            head.op,
            f"circular wait across {len(cycle)} warpgroup(s); "
            f"{len(blocked)} of {self.n_wgs} warpgroups blocked at "
            f"quiescence",
            witness=tuple(hops)))
        return out


def _shortest_cycle(edges: Dict[int, List[int]]) -> Optional[List[int]]:
    """Minimal witness: BFS from each node over the wait-for edges; the
    shortest path back to its start is the smallest cycle through it."""
    best: Optional[List[int]] = None
    for start in sorted(edges):
        prev: Dict[int, Optional[int]] = {start: None}
        q = deque([start])
        found: Optional[List[int]] = None
        while q and found is None:
            u = q.popleft()
            for v in edges.get(u, ()):
                if v == start:
                    path, node = [], u
                    while node is not None:
                        path.append(node)
                        node = prev[node]
                    found = list(reversed(path))     # [start, ..., u]
                    break
                if v not in prev:
                    prev[v] = u
                    q.append(v)
        if found is not None and (best is None or len(found) < len(best)):
            best = found
    return best


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def verify_cta(trace) -> List[Finding]:
    """All findings for one lowered :class:`CTATrace`."""
    meta = _Meta(trace)
    findings = _check_sid_spaces(trace, meta)
    for wi, instrs in enumerate(trace.wgs):
        findings += _check_wg_protocol(trace, meta, wi, instrs)
    findings += _check_counts(trace, meta)
    ax = _AbstractCTA(trace, meta)
    blocked = ax.run()
    if blocked:
        findings += ax.diagnose(blocked)
    return findings


def _signature(trace):
    return (tuple(tuple(wg) for wg in trace.wgs),
            trace.n_consumers,
            tuple(sorted((getattr(trace, "rings", None) or {}).items())),
            tuple(sorted((getattr(trace, "tokens", None) or {}).items())))


def verify_ctas(ctas: Sequence, kernel: str = "?") -> VerifyReport:
    """Verify a lowered launch, deduplicating structurally identical CTAs
    (a launch is thousands of copies of a handful of shapes)."""
    rep = VerifyReport(kernel=kernel, n_ctas=len(ctas))
    seen = set()
    for trace in ctas:
        sig = _signature(trace)
        if sig in seen:
            continue
        seen.add(sig)
        rep.findings.extend(verify_cta(trace))
    rep.n_unique = len(seen)
    return rep


def verify_spec(spec, cfg=None, w=None, tiling=None,
                max_ctas: Optional[int] = 64) -> VerifyReport:
    """Lower a spec's probe launch (or the given workload) and verify it.
    This is what ``registry.get`` runs once per spec at resolve time."""
    if cfg is None:
        from repro_torch.core.machine import H800
        cfg = H800
    if w is None:
        w = spec.probe_workload()
    ctas, _ = spec.build(cfg, w, tiling=tiling, max_ctas=max_ctas)
    return verify_ctas(ctas, kernel=getattr(spec, "name", "?"))
