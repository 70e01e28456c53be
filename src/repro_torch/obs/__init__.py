"""Observability layer: simulated PM counters, Perfetto export, manifests.

``obs`` is the metrics surface between the cycle engine and the outside
world — what Nsight Compute is to a real GPU:

  * :mod:`repro_torch.obs.labels` — the ``cta{i}/{role}`` label convention,
    single source of truth for everything that names a warpgroup lane;
  * :mod:`repro_torch.obs.counters` — opt-in :class:`CounterSink` sampling
    NCU-style windowed timelines off the engine, bit-neutral by design;
  * :mod:`repro_torch.obs.trace_export` — PipeEvent trace + counter tracks
    lowered to Chrome ``trace_event`` JSON (ui.perfetto.dev);
  * :mod:`repro_torch.obs.report` — NCU-style per-kernel section report
    (speed-of-light %, occupancy, stall buckets);
  * :mod:`repro_torch.obs.manifest` — run provenance stamped onto every
    simulate/sweep/bench artifact.

See docs/observability.md for the walkthrough.
"""
from repro_torch.obs.counters import CounterSink, role_stall_timelines
from repro_torch.obs.manifest import (build_manifest, config_hash, git_sha,
                                host_fingerprint, host_info, same_host,
                                subsystem_wall_breakdown)
from repro_torch.obs.report import build_report, render_report
from repro_torch.obs.trace_export import build_trace, export_trace

__all__ = [
    "CounterSink", "role_stall_timelines",
    "build_manifest", "config_hash", "git_sha", "host_fingerprint",
    "host_info", "same_host", "subsystem_wall_breakdown",
    "build_report", "render_report",
    "build_trace", "export_trace",
]
