"""Run provenance manifests — "who produced this number, where, and how".

Every artifact the simulator emits (``SimResult``, sweep cache files,
``report.save_json`` payloads, BENCH_engine.json rows, Perfetto traces)
gets stamped with a manifest so results stay attributable after the code
moves on:

  * **code**: git sha + dirty flag of the repo that ran;
  * **host**: platform/python fingerprint, hashed into ``host_id`` so perf
    gates can compare like-for-like hosts instead of absolute cycles/s;
  * **run**: machine/workload/kernel config hashes, scheduler, counter
    window, wall time, simulated cycles, events/s;
  * **wall_breakdown**: optional host-side per-subsystem wall split
    (cProfile tottime aggregated by top-level module — ``core.engine``,
    ``core.memory``, ``analysis``, ...), replacing one-off profiler runs
    as the backing for perf claims in docs/performance.md.

Manifests are plain JSON-serializable dicts (schema in
docs/observability.md); ``build_manifest`` fills what it can and omits
what it is not given, so cheap call sites stay cheap.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import platform
import subprocess
import sys
import time
from typing import Any, Dict, Optional

MANIFEST_VERSION = 1


def _hash(obj: Any) -> str:
    """Stable short hash of any JSON-serializable object."""
    blob = json.dumps(obj, sort_keys=True, default=str).encode()
    return hashlib.md5(blob).hexdigest()[:12]


def config_hash(obj: Any) -> str:
    """Short content hash of a config-ish object (dataclass, dict, ...)."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return _hash(dataclasses.asdict(obj))
    return _hash(obj)


_GIT_SHA_CACHE: Dict[Optional[str], str] = {}


def git_sha(root: Optional[str] = None) -> str:
    """Current git sha (12 chars, ``-dirty`` suffixed), or ``"unknown"``.
    Memoized per root — sweeps stamp hundreds of manifests per process and
    must not shell out to git for each one."""
    if root in _GIT_SHA_CACHE:
        return _GIT_SHA_CACHE[root]
    _GIT_SHA_CACHE[root] = sha = _git_sha_uncached(root)
    return sha


def _git_sha_uncached(root: Optional[str]) -> str:
    try:
        sha = subprocess.check_output(
            ["git", "rev-parse", "--short=12", "HEAD"],
            cwd=root, stderr=subprocess.DEVNULL, text=True).strip()
        dirty = subprocess.run(
            ["git", "diff", "--quiet", "HEAD"],
            cwd=root, stderr=subprocess.DEVNULL).returncode != 0
        return sha + ("-dirty" if dirty else "")
    except Exception:
        return "unknown"


def host_info() -> Dict[str, str]:
    """The host attributes that matter for wall-clock comparability."""
    return {
        "system": platform.system(),
        "machine": platform.machine(),
        "processor": platform.processor(),
        "python": "%d.%d.%d" % sys.version_info[:3],
        "impl": platform.python_implementation(),
    }


def host_fingerprint(info: Optional[Dict[str, str]] = None) -> str:
    """Short hash identifying a host class for like-for-like perf gates.
    Two runs with equal fingerprints may be compared on cycles/s; runs
    with different fingerprints may not (see bench_engine smoke gate)."""
    return _hash(info if info is not None else host_info())


def build_manifest(*,
                   machine: Any = None,
                   workload: Any = None,
                   kernel: Optional[str] = None,
                   tiling: Any = None,
                   scheduler: Optional[str] = None,
                   fidelity: Optional[str] = None,
                   mem_fidelity: Optional[str] = None,
                   counter_window: Optional[int] = None,
                   wall_s: Optional[float] = None,
                   sim_cycles: Optional[int] = None,
                   events_popped: Optional[int] = None,
                   wall_breakdown: Optional[Dict[str, float]] = None,
                   faults: Any = None,
                   extra: Optional[Dict[str, Any]] = None
                   ) -> Dict[str, Any]:
    """Assemble a provenance manifest dict.  All sections are optional;
    unknown/ungiven fields are simply omitted (cheap call sites stay
    cheap — git is shelled out to once per call, everything else is
    in-process)."""
    hi = host_info()
    m: Dict[str, Any] = {
        "manifest_version": MANIFEST_VERSION,
        "git_sha": git_sha(),
        "timestamp": time.strftime("%Y-%m-%dT%H:%M:%S%z"),
        "host": hi,
        "host_id": host_fingerprint(hi),
    }
    if machine is not None:
        m["machine_hash"] = config_hash(machine)
        m["machine_name"] = getattr(machine, "name", None)
    if workload is not None:
        m["workload_hash"] = config_hash(workload)
    if kernel is not None:
        m["kernel"] = kernel
    if tiling is not None:
        m["tiling_hash"] = config_hash(tiling)
    if scheduler is not None:
        m["scheduler"] = scheduler
    if fidelity is not None:
        m["fidelity"] = fidelity
    if mem_fidelity is not None:
        # tile-mode rows time differently from line-exact rows: the smoke
        # gate must never compare cycles/s across memory fidelities
        m["mem_fidelity"] = mem_fidelity
    if counter_window is not None:
        m["counter_window"] = counter_window
    if wall_s is not None:
        m["wall_s"] = round(wall_s, 6)
    if sim_cycles is not None:
        m["sim_cycles"] = sim_cycles
        if wall_s:
            m["cycles_per_s"] = round(sim_cycles / wall_s, 1)
    if events_popped is not None:
        m["events_popped"] = events_popped
        if wall_s:
            m["events_per_s"] = round(events_popped / wall_s, 1)
    if wall_breakdown is not None:
        m["wall_breakdown"] = wall_breakdown
    if faults is not None:
        # fault/variability provenance: a perturbed number is only
        # attributable if the artifact says which plan + seed produced it
        fd = faults.to_dict() if hasattr(faults, "to_dict") else dict(faults)
        m["fault_plan_hash"] = _hash(fd)
        m["fault_seed"] = fd.get("seed")
        m["fault_plan"] = {"name": fd.get("name") or None,
                           "kinds": sorted({p.get("kind") for p in
                                            fd.get("perturbations", ())})}
    if extra:
        m.update(extra)
    return m


def same_host(a: Optional[Dict[str, Any]], b: Optional[Dict[str, Any]]
              ) -> bool:
    """True when two manifests come from the same host class (their
    wall-clock rates are comparable)."""
    if not a or not b:
        return False
    ha, hb = a.get("host_id"), b.get("host_id")
    return ha is not None and ha == hb


# ---------------------------------------------------------------------------
# host-side subsystem wall breakdown (cProfile-backed)
# ---------------------------------------------------------------------------

_SUBSYSTEMS = ("core/engine", "core/memory", "core/kprog", "core",
               "analysis", "obs", "benchmarks")


def _subsystem_of(filename: str) -> str:
    norm = filename.replace("\\", "/")
    if "/repro_torch/" in norm:
        tail = norm.split("/repro_torch/", 1)[1]
        for sub in _SUBSYSTEMS:
            if tail.startswith(sub + "/") or tail == sub + ".py" or \
                    tail.startswith(sub + "."):
                return sub.replace("/", ".")
        return "repro_torch.other"
    if "/benchmarks/" in norm or norm.startswith("benchmarks/"):
        return "benchmarks"
    return "stdlib/other"


def subsystem_wall_breakdown(fn, *args, **kwargs):
    """Run ``fn(*args, **kwargs)`` under cProfile and return
    ``(result, {subsystem: wall-second tottime})`` — self-time aggregated
    by module path so "X% of wall is the memory hierarchy" style claims
    are reproducible with one call instead of a hand-driven profiler
    session (docs/performance.md cites this)."""
    import cProfile
    import pstats

    prof = cProfile.Profile()
    result = prof.runcall(fn, *args, **kwargs)
    stats = pstats.Stats(prof)
    out: Dict[str, float] = {}
    for (filename, _lineno, _name), row in stats.stats.items():
        tottime = row[2]
        if tottime <= 0:
            continue
        key = _subsystem_of(filename)
        out[key] = out.get(key, 0.0) + tottime
    return result, {k: round(v, 4) for k, v in
                    sorted(out.items(), key=lambda kv: -kv[1])}
