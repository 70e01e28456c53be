"""Runtime fault session: a :class:`FaultPlan` compiled into the cheap
per-event hooks the engine and memory hierarchy consult.

Hook discipline (the PR-7 counter-sink / PR-8 sanitizer contract): every
hook site in ``core/engine.py`` / ``core/memory.py`` costs a single
``is not None`` test when no session is attached, and a session compiled
from an identity plan returns +0 extra cycles / x1.0 compute scale from
every hook — so attaching it is bit-exact by construction.  All sampling
goes through one private ``random.Random(plan.seed)``; the engine's own
RNG (the RemoteCopy draw stream in ``L2Cache.rng``) is never touched, so
perturbed runs stay reproducible from ``(plan, seed)`` and unperturbed
state stays byte-identical.

The session also keeps *injection stats* — how many extra cycles each
perturbation class added, per category — which the obs layer surfaces
(``CounterSink`` fault series, report "faults" section, manifest stamp).
"""
from __future__ import annotations

import random
from typing import Dict, List, Optional, Tuple

from repro_torch.faults.plan import (
    CompletionDelay,
    DramJitter,
    FaultPlan,
    Jitter,
    L2Jitter,
    SmOffline,
    SmSlowdown,
    ThrottleWindow,
    TmaJitter,
)


class FaultSession:
    """Compiled runtime form of a :class:`FaultPlan`.

    Built by ``Engine.__init__`` (one session per engine run — sessions
    hold RNG state and injection counters, so they are never shared);
    consulted from the DRAM/L2/LRC push sites, the TMA submit/finish
    paths, the tensor-core pump and the BUBBLES executor."""

    __slots__ = ("plan", "rng", "_dram", "_l2_near", "_l2_far", "_tma",
                 "_completion", "_slow_all", "_slow_by_sm", "_throttles",
                 "offline", "injected", "events")

    def __init__(self, plan: FaultPlan, n_sms: int):
        self.plan = plan
        self.rng = random.Random(plan.seed)
        self._dram: List[Jitter] = []
        self._l2_near: List[Jitter] = []
        self._l2_far: List[Jitter] = []
        self._tma: List[Jitter] = []
        self._completion: List[Jitter] = []
        self._slow_all = 1.0                    # chip-wide static factor
        self._slow_by_sm: Dict[int, float] = {}
        self._throttles: List[Tuple[int, int, float]] = []
        offline = set()
        for p in plan.perturbations:
            if isinstance(p, DramJitter):
                self._dram.append(p.jitter)
            elif isinstance(p, L2Jitter):
                if p.near:
                    self._l2_near.append(p.jitter)
                if p.far:
                    self._l2_far.append(p.jitter)
            elif isinstance(p, TmaJitter):
                self._tma.append(p.jitter)
            elif isinstance(p, CompletionDelay):
                self._completion.append(p.jitter)
            elif isinstance(p, SmSlowdown):
                if p.sms:
                    for s in p.sms:
                        self._slow_by_sm[s] = \
                            self._slow_by_sm.get(s, 1.0) * p.factor
                else:
                    self._slow_all *= p.factor
            elif isinstance(p, SmOffline):
                offline.update(p.sms)
            elif isinstance(p, ThrottleWindow):
                if p.factor > 1.0 and p.t1 > p.t0:
                    self._throttles.append((p.t0, p.t1, p.factor))
        self.offline = frozenset(s for s in offline if 0 <= s < n_sms)
        if n_sms and len(self.offline) >= n_sms:
            raise ValueError(
                f"FaultPlan {plan.name!r} offlines all {n_sms} SMs — "
                "nothing could ever be dispatched")
        # extra cycles injected, per category (obs surfaces these)
        self.injected: Dict[str, int] = {
            "dram": 0, "l2": 0, "tma": 0, "completion": 0, "compute": 0}
        self.events: Dict[str, int] = {
            "dram": 0, "l2": 0, "tma": 0, "completion": 0, "compute": 0}

    # -- latency hooks (return extra cycles, >= 0) -------------------------
    def _draw(self, jits: List[Jitter], cat: str) -> int:
        extra = 0
        rng = self.rng
        for j in jits:
            extra += j.sample(rng)
        if extra:
            self.injected[cat] += extra
            self.events[cat] += 1
        return extra

    def dram_extra(self) -> int:
        """Extra latency for one DRAM channel access."""
        if not self._dram:
            return 0
        return self._draw(self._dram, "dram")

    def l2_extra(self, far: bool) -> int:
        """Extra latency for one L2 access (hit or miss lookup)."""
        jits = self._l2_far if far else self._l2_near
        if not jits:
            return 0
        return self._draw(jits, "l2")

    def tma_extra(self) -> int:
        """Extra descriptor/launch setup for one submitted TMA job."""
        if not self._tma:
            return 0
        return self._draw(self._tma, "tma")

    def finish_delay(self) -> int:
        """Delay between a TMA job's last line landing and its completion
        (mbarrier signal / store-group retirement) becoming visible."""
        if not self._completion:
            return 0
        return self._draw(self._completion, "completion")

    # -- compute hooks -----------------------------------------------------
    def compute_scale(self, cycle: int, sm_id: int) -> float:
        """Static x throttle-window compute stretch factor (>= 1.0)."""
        f = self._slow_all
        by_sm = self._slow_by_sm
        if by_sm:
            f *= by_sm.get(sm_id, 1.0)
        for t0, t1, tf in self._throttles:
            if t0 <= cycle < t1:
                f *= tf
        return f

    def stretch(self, cycle: int, sm_id: int, dur: int) -> int:
        """Apply the compute stretch to a duration; exact no-op at x1.0."""
        f = self.compute_scale(cycle, sm_id)
        if f == 1.0:
            return dur
        out = max(1, int(round(dur * f)))
        if out > dur:
            self.injected["compute"] += out - dur
            self.events["compute"] += 1
        return out

    # -- observability -----------------------------------------------------
    def stats(self) -> Dict[str, object]:
        return {
            "plan": self.plan.describe(),
            "injected_cycles": dict(self.injected),
            "injection_events": dict(self.events),
            "offline_sms": sorted(self.offline),
        }


def make_session(plan: Optional[FaultPlan], n_sms: int
                 ) -> Optional[FaultSession]:
    """``Engine.__init__`` entry: None / dict / FaultPlan -> session.

    Accepting the ``to_dict`` form lets plans cross process boundaries
    (sweep workers) and config files without an import dance."""
    if plan is None:
        return None
    if isinstance(plan, dict):
        plan = FaultPlan.from_dict(plan)
    if not isinstance(plan, FaultPlan):
        raise TypeError(f"faults= expects FaultPlan | dict | None, "
                        f"got {type(plan).__name__}")
    return FaultSession(plan, n_sms)
