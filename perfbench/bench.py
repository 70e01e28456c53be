"""What the harness reads from ``BENCHMARK.json`` and the files under ``perfbench/``.

A cell (an entry of ``workloads``) names a configuration and a traffic mix.
Everything that belongs to one of them sits in a file of its own, found by
name, so that a new cell, configuration, traffic mix or per-layer metric is
added by adding files and entries:

- ``configs/<config>.json`` (the path in ``configs[].file``): the sizes run,
  the source, the cuts (``reduced``) and the departures;
- ``traffic/<traffic>.json``: the mix's parameters, and the driver
  (``drivers/<driver>.py``) that runs the entry the window drives;
- ``limits/<cell>.json``: the limit of each number the correctness check
  compares, with the readings it was set from;
- ``metrics/<name>.py``, or ``metrics/<name before the first dot>.py`` for a
  metric whose suffix names the end-to-end metric it moves: a reader of one
  per-layer metric.

This module imports neither torch nor the program.
"""
from __future__ import annotations

import importlib.util
import json
import math
import sys
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BENCHMARK = ROOT / "BENCHMARK.json"
# top-level module names that may not be loaded in a run that prints a result
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def benchmark(path: Path = BENCHMARK) -> Dict[str, Any]:
    return load_json(path)


def cell(bench: Dict[str, Any], name: str) -> Dict[str, Any]:
    """The ``workloads`` entry ``name`` with its configuration entry and the
    parsed configuration and traffic files under ``config_file`` / ``traffic_file``,
    and the cell's limits under ``limits``."""
    for w in bench["workloads"]:
        if w["name"] == name:
            break
    else:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: "
                       f"{[w['name'] for w in bench['workloads']]}")
    conf = next(c for c in bench["configs"] if c["name"] == w["config"])
    return {**w, "config_entry": conf,
            "config_file": load_json(ROOT / conf["file"]),
            "traffic_file": load_json(HERE / "traffic" / f"{w['traffic']}.json"),
            "limits": load_json(HERE / "limits" / f"{name}.json")}


def end_to_end_of(bench: Dict[str, Any], name: str) -> List[Dict[str, Any]]:
    """The end-to-end metrics cell ``name`` reports: those without a
    ``workloads`` key and those that list it."""
    return [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]


def per_layer_of(bench: Dict[str, Any], name: str) -> List[Dict[str, Any]]:
    """The per-layer metrics cell ``name`` reports: those that list it, and
    those without a ``workloads`` key whose moved metric the cell reports."""
    e2e = {m["name"] for m in end_to_end_of(bench, name)}
    return [m for m in bench["per_layer"]
            if name in m.get("workloads", [name] if m["moves"] in e2e else [])]


def module_from(path: Path, label: str):
    """The module in ``path``, loaded under ``label`` (file names may hold dots)."""
    spec = importlib.util.spec_from_file_location(label, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[label] = mod
    spec.loader.exec_module(mod)
    return mod


def driver(name: str):
    """``drivers/<name>.py``."""
    return module_from(HERE / "drivers" / f"{name}.py", f"perfbench_driver_{name}")


def metric_file(name: str) -> Path:
    """``metrics/<name>.py``, else ``metrics/<name up to its first dot>.py``."""
    whole = HERE / "metrics" / f"{name}.py"
    return whole if whole.exists() else HERE / "metrics" / f"{name.split('.')[0]}.py"


def metric_module(name: str):
    """The metric's file, loaded: its ``read(name, record)``, its ``LAYER``,
    and, where it reads the card time under a host operation or range, that
    name as ``ATTRIBUTE``."""
    path = metric_file(name)
    return module_from(path, f"perfbench_metric_{path.stem.replace('.', '_')}")


def metric_reader(name: str) -> Callable[[str, Dict[str, Any]], Optional[float]]:
    """The ``read(name, record)`` of the metric's file."""
    return metric_module(name).read


def forbidden_loaded(modules) -> List[str]:
    """The names in ``modules`` (e.g. ``sys.modules``) whose top-level name,
    compared whole, is one that a run may not load."""
    return sorted(m for m in modules if m.split(".")[0] in FORBIDDEN_MODULES)


# ---------------------------------------------------------------------------
# statistics
# ---------------------------------------------------------------------------

def percentile(values: List[float], q: float) -> float:
    """The ``q``-th percentile (0-100) of every value, linear between the two
    nearest ranks (numpy's default method)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)
