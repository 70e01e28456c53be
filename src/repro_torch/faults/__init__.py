"""Fault injection & variability modeling (docs/robustness.md).

Public surface:

  * :class:`FaultPlan` + the perturbation catalogue — declarative, seeded
    variability scenarios attached via ``Engine(faults=...)`` /
    ``simulate(..., faults=...)``.
  * :class:`Watchdog` — wall-clock / sim-cycle run budgets with clean
    abort + partial-result salvage (``Engine(watchdog=...)``).
  * :func:`measured_variability` — the default plan built from the
    microbenchmarked Hopper envelopes in ``core.machine.H800_VARIABILITY``.
  * :mod:`repro_torch.faults.sensitivity` — perturbation-magnitude sweep driver
    (the robustness analogue of ``analysis.whatif``), also the step-time
    sampler that feeds ``serve.engine.StragglerPolicy``.
"""
from repro_torch.faults.plan import (
    CompletionDelay,
    DramJitter,
    FaultPlan,
    Jitter,
    L2Jitter,
    Perturbation,
    SmOffline,
    SmSlowdown,
    ThrottleWindow,
    TmaJitter,
)
from repro_torch.faults.session import FaultSession, make_session
from repro_torch.faults.watchdog import Watchdog, WatchdogState, make_watchdog

__all__ = [
    "CompletionDelay", "DramJitter", "FaultPlan", "FaultSession", "Jitter",
    "L2Jitter", "Perturbation", "SmOffline", "SmSlowdown", "ThrottleWindow",
    "TmaJitter", "Watchdog", "WatchdogState", "make_session",
    "make_watchdog", "measured_variability",
]


def measured_variability(scale: float = 1.0, seed: int = 0,
                         throttle: bool = False) -> FaultPlan:
    """The measured-Hopper-spread plan: normal latency jitters at the
    ``H800_VARIABILITY`` one-sigma envelopes (times ``scale``), plus —
    when ``throttle=True`` — a chip-wide sustained power-cap derate.

    ``scale=0`` is exactly the identity plan (the bit-exactness anchor in
    tests), which makes it the natural sweep axis for
    ``faults.sensitivity``: 0 -> ideal paper model, 1 -> measured spread,
    >1 -> stress."""
    from repro_torch.core.machine import H800_VARIABILITY as V
    perts = [
        DramJitter(Jitter("normal", 0.0, V["dram_jitter_std"] * scale)),
        L2Jitter(Jitter("normal", 0.0, V["l2_near_jitter_std"] * scale),
                 near=True, far=False),
        L2Jitter(Jitter("normal", 0.0, V["l2_far_jitter_std"] * scale),
                 near=False, far=True),
        TmaJitter(Jitter("normal", 0.0, V["tma_jitter_std"] * scale)),
        CompletionDelay(
            Jitter("normal", 0.0, V["completion_jitter_std"] * scale)),
    ]
    if throttle and scale > 0:
        perts.append(SmSlowdown(
            factor=1.0 + (V["throttle_factor"] - 1.0) * scale))
    return FaultPlan(tuple(perts), seed=seed,
                     name=f"measured_variability(x{scale:g})")
