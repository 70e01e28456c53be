"""repro_torch.analysis: dependency-DAG pipeline analysis for Sim-FA traces.

Modules (import them explicitly; only the pure event layer is re-exported
here so that ``core.engine`` can import the tracer without a cycle):

  * ``events``        — typed :class:`PipeEvent` records + the engine tracer
  * ``dag``           — dependency-DAG construction over an event trace
  * ``critical_path`` — critical path extraction + per-WG stall attribution
  * ``whatif``        — DAG replay under scaled resource costs
  * ``sweep``         — multiprocessing what-if sweep driver w/ JSON caching
  * ``report``        — text / JSON report rendering
  * ``hazards``       — runtime hazard sanitizer (``Engine(sanitize=True)``)
                        + deadlock wait-for-graph explainer
"""
from repro_torch.analysis.events import EventTracer, PipeEvent  # noqa: F401

__all__ = ["EventTracer", "PipeEvent", "events", "dag", "critical_path",
           "whatif", "sweep", "report", "hazards"]
