"""Engine watchdog: wall-clock / sim-cycle budgets with clean salvage.

A runaway configuration (a perturbed plan that starves a consumer, a
what-if machine variant that livelocks the ring, a sweep point that is
simply enormous) used to mean either an un-interruptible multi-hour run
or a killed process with nothing to show.  ``Engine(watchdog=Watchdog(...))``
bounds a run two ways:

  * ``max_cycles`` — a *simulated-time* budget.  The event-driven run
    loop jumps, so the budget is enforced by clamping every time jump to
    the budget cycle and tripping at the loop top — the abort lands *at*
    the budget, not wherever the next event happened to be.
  * ``max_wall_s`` — a *host-time* budget, checked every ``check_every``
    loop iterations via a countdown (one ``perf_counter`` call per batch,
    so the hook costs ~nothing on the hot loop).

On trip the engine aborts cleanly instead of raising: the run loop breaks,
the counter sink's ``finish`` still runs (PM timelines up to the abort are
salvaged), and :func:`salvage` snapshots what a post-mortem needs —
retired / in-flight / pending CTA census per SM, and the same blocked-
thread explanation ``deadlock_info`` carries (``analysis.hazards.
explain_deadlock`` is deliberately reused: it only reads engine state, so
it is as happy to explain "who was waiting at the abort" as a true
deadlock).  The engine exposes ``aborted`` / ``abort_info``; ``simulate``
forwards both onto ``SimResult`` and the obs report renders an "abort"
section.

Like the fault session, the watchdog is read-only over simulated state:
it never wakes, blocks or reorders anything, so a run that finishes under
budget is bit-exact with an unwatched run (asserted in tests/test_faults.py).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, Optional


@dataclass(frozen=True)
class Watchdog:
    """Declarative budget: attach via ``Engine(watchdog=...)`` or
    ``simulate(..., watchdog=...)``.  Either bound may be None."""
    max_wall_s: Optional[float] = None
    max_cycles: Optional[int] = None
    check_every: int = 256          # loop iterations per wall-clock check

    def __post_init__(self):
        if self.max_wall_s is not None and self.max_wall_s <= 0:
            raise ValueError("max_wall_s must be > 0")
        if self.max_cycles is not None and self.max_cycles <= 0:
            raise ValueError("max_cycles must be > 0")
        if self.check_every <= 0:
            raise ValueError("check_every must be > 0")


class WatchdogState:
    """Per-run armed state (the watchdog analogue of FaultSession)."""

    __slots__ = ("plan", "max_cycles", "deadline", "check_every",
                 "_countdown", "reason", "t0")

    def __init__(self, plan: Watchdog):
        self.plan = plan
        self.max_cycles = plan.max_cycles
        self.t0 = time.perf_counter()
        self.deadline = (self.t0 + plan.max_wall_s
                         if plan.max_wall_s is not None else None)
        self.check_every = plan.check_every
        self._countdown = plan.check_every
        self.reason = ""

    def tripped(self, cycle: int) -> bool:
        if self.max_cycles is not None and cycle >= self.max_cycles:
            self.reason = "cycle_budget"
            return True
        if self.deadline is not None:
            self._countdown -= 1
            if self._countdown <= 0:
                self._countdown = self.check_every
                if time.perf_counter() >= self.deadline:
                    self.reason = "wall_budget"
                    return True
        return False

    def clamp(self, cycle: int) -> int:
        """Clamp a time jump so the abort lands at the cycle budget."""
        mc = self.max_cycles
        if mc is not None and cycle > mc:
            return mc
        return cycle

    def wall_s(self) -> float:
        return time.perf_counter() - self.t0


def make_watchdog(plan) -> Optional[WatchdogState]:
    """``Engine.__init__`` entry: None / dict / Watchdog -> armed state."""
    if plan is None:
        return None
    if isinstance(plan, dict):
        plan = Watchdog(**plan)
    if not isinstance(plan, Watchdog):
        raise TypeError(f"watchdog= expects Watchdog | dict | None, "
                        f"got {type(plan).__name__}")
    return WatchdogState(plan)


def salvage(engine, reason: str, wall_s: float) -> Dict:
    """Partial-result snapshot at abort time (``engine.abort_info``).

    Read-only over engine state; runs after the loop has already decided
    to break, so it cannot perturb anything."""
    census = []
    for sm in engine.sms:
        if not sm.ctas:
            continue
        census.append({
            "sm": sm.sm_id,
            "resident_ctas": [cta.idx for cta in sm.ctas],
            "threads": [
                {"label": th.label, "pc": th.pc, "len": th.trace_len,
                 "state": ("done" if th.done() else
                           "stalled" if th.state == 1 else "ready")}
                for cta in sm.ctas for th in cta.threads
            ],
        })
    from repro_torch.analysis.hazards import explain_deadlock
    blocked = explain_deadlock(engine)
    info = {
        "reason": reason,
        "cycle": engine.cycle,
        "wall_s": round(wall_s, 3),
        "launched": engine.launched,
        "retired": engine.retired,
        "in_flight": engine.launched - engine.retired,
        "pending": len(engine.pending),
        "census": census,
        "blocked": blocked,
    }
    if engine.faults is not None:
        info["faults"] = engine.faults.stats()
    return info
