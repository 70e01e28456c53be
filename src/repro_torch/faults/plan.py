"""Declarative fault / variability plans.

The paper validates the engine at 5.7% MAPE under *ideal, locked-frequency*
conditions; real Hopper parts show measured latency/bandwidth spreads (the
two microbenchmarking studies in PAPERS.md — arxiv 2501.12084, 2402.13499 —
report wide L2 near/far and DRAM latency distributions, and thermally/
power-capped frequency excursions).  A :class:`FaultPlan` describes such a
variability scenario declaratively: a composition of :class:`Perturbation`
values plus a seed, JSON-round-trippable (``to_dict``/``from_dict``) so
plans can live in configs, sweep grids and manifests.

The plan itself is inert data.  It is compiled into runtime hooks by
:class:`repro_torch.faults.session.FaultSession` when attached via
``Engine(faults=plan)``; the contract (enforced in ``tests/test_faults.py``)
is:

  * **off is free** — ``Engine(faults=None)`` costs one ``is None`` test
    per hook site and is bit-exact with pre-faults engines;
  * **identity is exact** — an empty plan, or one whose perturbations all
    have zero magnitude, reproduces every stat and event bit-for-bit
    (perturbation draws only ever *add* cycles, and the fault RNG is
    private — the engine's own RNG stream is never touched);
  * **seeded is reproducible** — the same ``(plan, seed)`` yields the same
    stats/events on every run; a different seed yields a different (but
    equally reproducible) sample path.

Perturbation catalogue (docs/robustness.md has the worked examples):

  =================  ====================================================
  :class:`DramJitter`       extra latency per DRAM channel access
  :class:`L2Jitter`         extra latency per L2 hit/miss (near/far gated)
  :class:`TmaJitter`        extra descriptor/launch setup per TMA job
  :class:`CompletionDelay`  delayed delivery of async TMA completions
                            (mbarrier signal / store-group retirement)
  :class:`SmSlowdown`       per-SM compute stretch (bubbles + tensor core)
  :class:`SmOffline`        SMs removed from CTA dispatch entirely
  :class:`ThrottleWindow`   time-windowed global compute stretch
                            (thermal / power capping event)
  =================  ====================================================
"""
from __future__ import annotations

import math
from dataclasses import asdict, dataclass, field, fields, replace
from typing import Any, Dict, Tuple

DISTRIBUTIONS = ("constant", "uniform", "normal", "lognormal")


@dataclass(frozen=True)
class Jitter:
    """A non-negative integer-cycle latency distribution.

    ``cycles`` is the location parameter (the constant value / uniform
    midpoint / normal mean / lognormal median); ``spread`` the scale
    (uniform half-width / normal std / lognormal sigma).  Samples are
    clamped at zero — a perturbation can only ever *add* latency, which is
    what makes zero-magnitude jitters exactly identity."""
    dist: str = "constant"
    cycles: float = 0.0
    spread: float = 0.0

    def __post_init__(self):
        if self.dist not in DISTRIBUTIONS:
            raise ValueError(f"unknown jitter dist {self.dist!r}; "
                             f"expected one of {DISTRIBUTIONS}")
        if self.cycles < 0 or self.spread < 0:
            raise ValueError("jitter cycles/spread must be >= 0")

    def is_zero(self) -> bool:
        return self.cycles == 0 and self.spread == 0

    def sample(self, rng) -> int:
        """One draw, in whole cycles, >= 0.  ``rng`` is the fault session's
        private ``random.Random``."""
        if self.is_zero():
            return 0
        d = self.dist
        if d == "constant":
            x = self.cycles
        elif d == "uniform":
            x = rng.uniform(self.cycles - self.spread,
                            self.cycles + self.spread)
        elif d == "normal":
            x = rng.gauss(self.cycles, self.spread)
        else:  # lognormal: median = cycles, sigma = spread
            x = (self.cycles or 1.0) * math.exp(rng.gauss(0.0, self.spread))
        return max(0, int(round(x)))


@dataclass(frozen=True)
class Perturbation:
    """Base marker; concrete perturbations carry a class-level ``kind``."""
    kind = "perturbation"

    def is_identity(self) -> bool:
        return False


@dataclass(frozen=True)
class DramJitter(Perturbation):
    """Extra latency per DRAM access (models the measured DRAM latency
    spread; applied on top of ``GPUMachine.dram_latency``)."""
    kind = "dram_jitter"
    jitter: Jitter = field(default_factory=Jitter)

    def is_identity(self) -> bool:
        return self.jitter.is_zero()


@dataclass(frozen=True)
class L2Jitter(Perturbation):
    """Extra latency per L2 access.  ``near``/``far`` gate which partition
    accesses draw (the microbenchmarked near/far spreads differ)."""
    kind = "l2_jitter"
    jitter: Jitter = field(default_factory=Jitter)
    near: bool = True
    far: bool = True

    def is_identity(self) -> bool:
        return self.jitter.is_zero() or not (self.near or self.far)


@dataclass(frozen=True)
class TmaJitter(Perturbation):
    """Extra descriptor/launch setup latency per submitted TMA job."""
    kind = "tma_jitter"
    jitter: Jitter = field(default_factory=Jitter)

    def is_identity(self) -> bool:
        return self.jitter.is_zero()


@dataclass(frozen=True)
class CompletionDelay(Perturbation):
    """Delayed delivery of an async TMA job completion: the cycles between
    the last line landing and the mbarrier signal / store-group retirement
    becoming visible to waiters."""
    kind = "completion_delay"
    jitter: Jitter = field(default_factory=Jitter)

    def is_identity(self) -> bool:
        return self.jitter.is_zero()


@dataclass(frozen=True)
class SmSlowdown(Perturbation):
    """Stretch compute durations (BUBBLES + tensor-core ops) on the listed
    SMs by ``factor`` (>= 1).  Empty ``sms`` means every SM — a chip-wide
    frequency derate."""
    kind = "sm_slowdown"
    factor: float = 1.0
    sms: Tuple[int, ...] = ()

    def __post_init__(self):
        if self.factor < 1.0:
            raise ValueError("SmSlowdown factor must be >= 1")

    def is_identity(self) -> bool:
        return self.factor == 1.0


@dataclass(frozen=True)
class SmOffline(Perturbation):
    """Remove SMs from CTA dispatch entirely (a dead/fenced SM)."""
    kind = "sm_offline"
    sms: Tuple[int, ...] = ()

    def is_identity(self) -> bool:
        return not self.sms


@dataclass(frozen=True)
class ThrottleWindow(Perturbation):
    """Global compute stretch by ``factor`` while ``t0 <= cycle < t1`` —
    a thermal or power-capping event."""
    kind = "throttle"
    t0: int = 0
    t1: int = 0
    factor: float = 1.0

    def __post_init__(self):
        if self.factor < 1.0:
            raise ValueError("ThrottleWindow factor must be >= 1")
        if self.t1 < self.t0:
            raise ValueError("ThrottleWindow needs t0 <= t1")

    def is_identity(self) -> bool:
        return self.factor == 1.0 or self.t1 <= self.t0


PERTURBATION_TYPES = {
    cls.kind: cls for cls in (DramJitter, L2Jitter, TmaJitter,
                              CompletionDelay, SmSlowdown, SmOffline,
                              ThrottleWindow)
}


@dataclass(frozen=True)
class FaultPlan:
    """A named, seeded composition of perturbations.

    ``FaultPlan(())`` / :meth:`identity` is the do-nothing plan — attaching
    it must be bit-exact (the acceptance bar).  ``seed`` drives the fault
    session's private RNG; :meth:`with_seed` derives sibling sample paths
    for Monte-Carlo use (``faults.sensitivity.step_time_samples``)."""
    perturbations: Tuple[Perturbation, ...] = ()
    seed: int = 0
    name: str = ""

    def __post_init__(self):
        object.__setattr__(self, "perturbations", tuple(self.perturbations))

    @staticmethod
    def identity(name: str = "identity") -> "FaultPlan":
        return FaultPlan((), name=name)

    def is_identity(self) -> bool:
        return all(p.is_identity() for p in self.perturbations)

    def with_seed(self, seed: int) -> "FaultPlan":
        return replace(self, seed=seed)

    # -- declarative round-trip --------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "seed": self.seed,
            "perturbations": [{"kind": p.kind, **asdict(p)}
                              for p in self.perturbations],
        }

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "FaultPlan":
        perts = []
        for pd in d.get("perturbations", ()):
            pd = dict(pd)
            kind = pd.pop("kind")
            cls = PERTURBATION_TYPES.get(kind)
            if cls is None:
                raise ValueError(f"unknown perturbation kind {kind!r}")
            for f in fields(cls):
                if f.name in pd and isinstance(pd[f.name], dict):
                    pd[f.name] = Jitter(**pd[f.name])
                elif f.name in pd and isinstance(pd[f.name], list):
                    pd[f.name] = tuple(pd[f.name])
            perts.append(cls(**pd))
        return FaultPlan(tuple(perts), seed=d.get("seed", 0),
                         name=d.get("name", ""))

    def describe(self) -> Dict[str, Any]:
        """Compact summary for manifests / reports."""
        return {
            "name": self.name or None,
            "seed": self.seed,
            "n_perturbations": len(self.perturbations),
            "kinds": sorted({p.kind for p in self.perturbations}),
            "identity": self.is_identity(),
        }
