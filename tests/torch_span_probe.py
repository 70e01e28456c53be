"""Two probes of the port's spans (``repro_torch/obs/spans.py``) on the card.

``clock_check(prof)`` sets the card's timestamps against the host's in one
profiler session, from both sides, through the profiler's links from each
card operation to its launch. An operation launched inside a
``repro.serve.decode`` range should start after that range opened and after
its launch: the most it reads before its launch bounds how early the card's
clock runs, the least lag from a launch to a start how late. And the card's
idle gaps whose midpoints lie in a ``repro.serve.decode`` range (those
``idle_launch_ms.gen`` counts) are told apart by the operation that ends
each: launched no earlier than ``TOL_US`` before the gap opened, the card
waited on that launch; launched earlier, the gap is the card's own between
queued operations. ``tests/test_torch_spans.py`` runs it on a few decode
ticks of a small model on the card.

``clock`` traces one run of a benchmark cell and prints the check of that
run's profile as the last line, after the run's own result line. ``cost``
prints the host cost of one span with the profiler off and of one range with
it on:

    python3 tests/torch_span_probe.py clock --workload command-r-plus-104b-l8.chat_1k_256 \
        --seed 2147490201 --seconds 45
    python3 tests/torch_span_probe.py cost
"""
from __future__ import annotations

import argparse
import json
import sys
from bisect import bisect_right
from pathlib import Path
from statistics import quantiles
from typing import Dict

ROOT = Path(__file__).resolve().parents[1]
SPAN = "repro.serve.decode"
TOL_US = 10.0          # a launch's own latency: the call's entry to the kernel's start


def _host(e) -> bool:
    return "CPU" in str(e.device_type())


def _card(e) -> bool:
    return "CUDA" in str(e.device_type()) and not e.is_user_annotation()


def _deciles(xs, prefix, out):
    if len(xs) >= 2:
        q = quantiles(xs, n=10)
        out[prefix + "_p50"], out[prefix + "_p90"] = q[4], q[8]


def clock_check(prof) -> Dict[str, float]:
    """From the raw events of the profile ``prof``
    (``prof.profiler.kineto_results``: each card operation is linked to its
    launch, the runtime call, by their correlation id). Of the card's
    operations launched inside a ``SPAN`` range: how many (``kernels``), how
    many start before their range opened (``before_range``) or before their
    launch (``before_launch``), the lag from launch to start, µs
    (``lag_us_min``, ``lag_us_p50``, ``lag_us_p90``). Of the card's idle gaps
    whose midpoints lie in a ``SPAN`` range: how many (``gaps``) and their µs
    (``gap_us``); those whose ending operation was launched no earlier than
    ``TOL_US`` before the gap opened (``gaps_waited``, ``gap_us_waited``),
    the lag from launch to start of those operations (``waited_lag_us_p50``,
    ``_p90``), and how many ending operations have no launch in the profile
    (``gaps_unlinked``)."""
    events = prof.profiler.kineto_results.events()
    spans = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                   for e in events if _host(e) and e.name() == SPAN)
    starts = [s for s, _ in spans]

    def opened(t):
        """The start of the ``SPAN`` range that holds host time ``t``, or None
        (the ranges do not overlap: one thread steps the engine)."""
        i = bisect_right(starts, t) - 1
        return spans[i][0] if i >= 0 and t <= spans[i][1] else None

    launches = {e.correlation_id(): e.start_ns() for e in events
                if _host(e) and e.name().startswith("cu") and e.correlation_id() > 0}
    card = sorted((k.start_ns(), k.start_ns() + k.duration_ns(), launches.get(k.correlation_id()))
                  for k in events if _card(k))
    out = {"ranges": len(spans), "kernels": 0, "before_range": 0, "before_launch": 0,
           "gaps": 0, "gap_us": 0.0, "gaps_waited": 0, "gap_us_waited": 0.0,
           "gaps_unlinked": 0}
    lags, waited = [], []
    busy_to = card[0][0] if card else 0
    for start, end, t in card:
        since = None if t is None else opened(t)
        if since is not None:
            out["kernels"] += 1
            out["before_range"] += start < since
            out["before_launch"] += start < t
            lags.append((start - t) / 1e3)
        if start > busy_to and opened((busy_to + start) / 2) is not None:
            out["gaps"] += 1
            out["gap_us"] += (start - busy_to) / 1e3
            if t is None:
                out["gaps_unlinked"] += 1
            elif t >= busy_to - TOL_US * 1e3:
                out["gaps_waited"] += 1
                out["gap_us_waited"] += (start - busy_to) / 1e3
                waited.append((start - t) / 1e3)
        busy_to = max(busy_to, end)
    if lags:
        out["lag_us_min"] = min(lags)
    _deciles(lags, "lag_us", out)
    _deciles(waited, "waited_lag_us", out)
    return out


def _clock(a) -> int:
    from perfbench import bench, trace
    run = bench.module_from(ROOT / "perfbench" / "run.py", "perfbench_run")
    reduce, checks = trace.Trace.of.__func__, []

    def of(cls, prof, *args, **kw):
        checks.append(clock_check(prof))
        return reduce(cls, prof, *args, **kw)

    trace.Trace.of = classmethod(of)
    rc = run.main(["--workload", a.workload, "--seed", str(a.seed),
                   "--seconds", str(a.seconds), "--trace", "1"])
    print(json.dumps({"clock_check": checks[-1] if checks else None}), flush=True)
    return rc


def _span_ns(n: int = 200_000) -> Dict[str, float]:
    """Host ns of one ``with`` over each span, less an empty loop's: with the
    profiler off (``span``, ``serving_span`` under ``no_grad``), and inside
    an active session of the host and the card (``span_profiled``: one
    ``record_function`` range)."""
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.obs import spans

    def per_pass(body, k=n):
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            body(k)
            best = min(best, (time.perf_counter() - t0) / k * 1e9)
        return best

    def bare(k):
        for _ in range(k):
            pass

    def span(k):
        for _ in range(k):
            with spans.span("engine.tick"):
                pass

    def serving(k):
        for _ in range(k):
            with spans.serving_span("model.attn"):
                pass

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with torch.no_grad():
        base = per_pass(bare)
        out = {"span_ns": per_pass(span) - base, "serving_span_ns": per_pass(serving) - base}
        with profile(activities=acts):
            out["span_profiled_ns"] = per_pass(span, n // 20) - per_pass(bare, n // 20)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("probe", choices=("clock", "cost"))
    ap.add_argument("--workload", help="clock: the benchmark cell to trace")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--seconds", type=float, default=45.0)
    a = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    if a.probe == "clock":
        return _clock(a)
    print(json.dumps(_span_ns()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
