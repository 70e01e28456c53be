"""One run of one cell: set-up, the measured window, the traced segment (with
``trace``), the correctness check, and the result line.

``run(ctx)`` returns the result's fields; ``perfbench/run.py`` is the command
that builds the ``Ctx`` from its arguments and prints the line.
"""
from __future__ import annotations

import gc
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import torch

from perfbench import bench, counts
from perfbench.trace import Trace


@dataclass
class Ctx:
    name: str                   # the cell
    conf: Dict[str, Any]        # its configuration file
    traffic: Dict[str, Any]     # its traffic file
    limits: Dict[str, Any]      # its limits file
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    chips: int = 1
    t_process: float = 0.0      # the process's start, host wall clock
    control: bool = False       # also read the control (lower precision)
    fault: Optional[str] = None  # a fault to plant in the program (tests, readings)
    host_loop_ms: Optional[float] = None  # the host's speed just before the window
    undo: List[Any] = field(default_factory=list)

    @classmethod
    def of_cell(cls, name: str, seed: int, seconds: float, trace: bool, device,
                bench_json=None, **kw) -> "Ctx":
        b = bench_json or bench.benchmark()
        c = bench.cell(b, name)
        return cls(name=name, conf=c["config_file"], traffic=c["traffic_file"],
                   limits=c["limits"], end_to_end=bench.end_to_end_of(b, name),
                   per_layer=bench.per_layer_of(b, name), seed=seed, seconds=seconds,
                   trace=trace, device=torch.device(device), chips=c["chips"], **kw)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def attributed_names(per_layer) -> List[str]:
    """The host operations and ranges whose card time the metrics
    ``per_layer`` read, as their files name them (``ATTRIBUTE``)."""
    return sorted({a for m in per_layer
                   for a in [getattr(bench.metric_module(m["name"]), "ATTRIBUTE", None)] if a})


def profile_of(ctx):
    """``profile(body) -> (trace, body's result)``: ``body`` traced by
    ``torch.profiler`` (the host's operations and the card's) inside a
    ``pb.window`` range, after one untraced profiler step (a window opened
    cold has been seen to miss its first kernel record), reduced to the
    ``Trace`` the per-layer metrics read, with the body's host wall. One
    profiler session a process: in a second session the card's timestamps
    were seen to drift from the host's by a tenth within a second. The
    trace attributes card time to the names that the cell's metric files
    ask for (``ATTRIBUTE``)."""
    from torch.profiler import ProfilerActivity, profile, record_function, schedule
    attribute = attributed_names(ctx.per_layer)

    def run(body):
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if ctx.device.type == "cuda" else [])
        with profile(activities=acts, schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                     acc_events=True) as prof:
            torch.ones(1, device=ctx.device).add_(1)
            _sync(ctx.device)
            prof.step()
            t0 = time.perf_counter()
            with record_function("pb.window"):
                out = body()
                _sync(ctx.device)
            wall = time.perf_counter() - t0
            prof.step()
        tr = Trace.of(prof, attribute=attribute)
        tr.wall_s = wall
        return tr, out
    return run


def host_loop_ms() -> float:
    """Milliseconds of a fixed loop of Python: how fast the host runs the
    interpreter now (a reading beside the host-paced metrics, compared with
    nothing)."""
    t0 = time.perf_counter()
    x = 0
    for i in range(300_000):
        x += i & 7
    return (time.perf_counter() - t0) * 1e3


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else None


def run(ctx: Ctx) -> Dict[str, Any]:
    """One run of ``ctx``'s cell; the result's fields, ``checks`` last."""
    drv = bench.driver(ctx.traffic["driver"])
    dev = ctx.device
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type
    limit_w = power_limit() if dev.type == "cuda" else None
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    st = drv.setup(ctx)
    _sync(dev)
    ctx.host_loop_ms = host_loop_ms()
    setup_s = time.time() - ctx.t_process if ctx.t_process else None
    rec = drv.window(ctx, st, ctx.seconds, ctx.trace)
    seg = drv.traced(ctx, st, profile_of(ctx)) if ctx.trace else None
    _sync(dev)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    attempted, failed = drv.counts_of(ctx, rec)

    if ctx.trace:
        pk = counts.peaks(kind)
        r = {"ctx": ctx, "rec": rec, "seg": seg, "trace": seg["trace"], "peaks": pk,
             "window_flops": drv.window_flops(ctx, rec)}
        metrics = {}
        for m in ctx.per_layer:
            v = bench.metric_reader(m["name"])(m["name"], r)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        e2e = dict(drv.end_to_end(ctx, rec), setup_s=setup_s)
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in ctx.end_to_end if e2e.get(m["name"]) is not None}

    t0 = time.time()
    readings = drv.check(ctx, st, rec)
    readings["check_s"] = time.time() - t0
    del st
    gc.collect()
    checks, correct = {}, True
    for name, lim in ctx.limits["numbers"].items():
        v = readings.get(name)
        ok = v is not None and v <= lim["limit"]
        correct = correct and ok
        checks[name] = {"value": v, "limit": lim["limit"]}
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type, "kind": kind,
              "count": ctx.chips, "memory_peak_bytes": peak}
    if limit_w:
        device["power_limit"] = limit_w
    out: Dict[str, Any] = {"correct": correct, "attempted": attempted, "failed": failed,
                           "metrics": metrics, "device": device}
    if ctx.trace:
        tr = seg["trace"]
        device["busy_s"], device["window_s"] = tr.busy_us() / 1e6, tr.wall_s
        out["breakdown"] = tr.breakdown()
    out["readings"] = {k: v for k, v in readings.items() if k not in checks}
    out["checks"] = checks
    return out


def report_checks(out: Dict[str, Any], stream=sys.stderr) -> None:
    """Each compared number beside its limit, one line each."""
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=stream, flush=True)
