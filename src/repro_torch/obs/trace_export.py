"""Perfetto / Chrome ``trace_event`` export of the pipeline trace.

Lowers a recorded :class:`~repro_torch.analysis.events.EventTracer` trace plus
optional :class:`~repro_torch.obs.counters.CounterSink` timelines to the Chrome
``trace_event`` JSON format (the "JSON object format": ``{"traceEvents":
[...]}``), loadable in ui.perfetto.dev or ``chrome://tracing`` — replacing
squinting at ``gantt.render_text`` with a real zoomable timeline.

Mapping (1 trace microsecond == 1 simulated cycle; real time at
``freq_ghz`` is noted in ``otherData``):

  * one thread per warpgroup label ``cta{i}/{role}`` (named via ``M``
    metadata events, sorted by CTA launch index);
  * softmax bubbles -> complete ``X`` slices on the warpgroup thread;
  * instruction issues -> zero-duration ``X`` slices (visible when zoomed;
    waits/acquires carry their ordinal operands in ``args``);
  * TMA jobs and WGMMA executions -> ``b``/``e`` async slices (they overlap
    the issuing lane and each other), categorized ``tma`` / ``wgmma``;
  * issue -> engine-op causality (``PipeEvent.src``) -> ``s``/``f`` flow
    arrows, so clicking a WGMMA shows which instruction launched it;
  * counter timelines -> ``C`` counter tracks (DRAM GB/s, L2 hit %, TC
    busy %, TMA in-flight lines, resident CTAs, per-(cta, ring) occupancy,
    per-role stall-bucket cycles).

Schema guarantees (enforced by ``tests/test_obs.py``): the export is valid
JSON, ``ts`` is monotonically non-decreasing per ``tid``, and every flow
arrow's start (``s``) and finish (``f``) endpoints both exist.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

from repro_torch.obs.labels import cta_of

PID = 0


def _percent(x: float) -> float:
    return round(100.0 * x, 2)


def build_trace(trace=None, counters=None, manifest: Optional[dict] = None,
                *, name: str = "sim-fa", ring_track_limit: int = 8,
                include_stalls: bool = True,
                stall_window: int = 256) -> Dict[str, Any]:
    """Build the ``trace_event`` JSON object (dict) from a PipeEvent trace
    and/or counter sink.  ``ring_track_limit`` caps how many CTAs get
    per-ring occupancy counter tracks (a full launch has hundreds of CTAs;
    unlimited with ``ring_track_limit=None``)."""
    events: List[Dict[str, Any]] = []
    meta: List[Dict[str, Any]] = []
    meta.append({"ph": "M", "pid": PID, "name": "process_name",
                 "args": {"name": name}})

    tids: Dict[str, int] = {}

    def tid_for(label: str) -> int:
        t = tids.get(label)
        if t is None:
            t = tids[label] = len(tids) + 1
        return t

    if trace is not None:
        _emit_pipe_events(trace, events, tid_for)
    if counters is not None:
        _emit_counter_tracks(counters, events, ring_track_limit)
    if include_stalls and trace is not None and trace.events:
        _emit_stall_tracks(trace, events, stall_window)

    for label, t in tids.items():
        c = cta_of(label)
        meta.append({"ph": "M", "pid": PID, "tid": t, "name": "thread_name",
                     "args": {"name": label}})
        meta.append({"ph": "M", "pid": PID, "tid": t,
                     "name": "thread_sort_index",
                     "args": {"sort_index": c if c is not None else t}})

    events.sort(key=lambda e: (e["ts"], e.get("tid", 0), e["ph"] != "e"))
    other: Dict[str, Any] = {"time_unit": "1 us == 1 simulated cycle"}
    if manifest:
        other["manifest"] = manifest
    return {"traceEvents": meta + events,
            "displayTimeUnit": "ms",
            "otherData": other}


def export_trace(path: str, trace=None, counters=None,
                 manifest: Optional[dict] = None, **kw) -> Dict[str, Any]:
    """Build and write the trace JSON to ``path``; returns the dict."""
    obj = build_trace(trace, counters, manifest, **kw)
    from repro_torch.utils.ioutil import atomic_write_json
    atomic_write_json(path, obj, indent=None, separators=(",", ":"))
    return obj


# ---------------------------------------------------------------------------
# lowering passes
# ---------------------------------------------------------------------------

def _emit_pipe_events(trace, events: List[Dict[str, Any]], tid_for) -> None:
    # eid -> (ts, tid) of the issue event, for flow-arrow endpoints
    issue_at: Dict[int, tuple] = {}
    for ev in trace.events:
        tid = tid_for(ev.label)
        if ev.kind == "issue":
            args: Dict[str, Any] = {"eid": ev.eid}
            if ev.sid >= 0:
                args["sid"] = ev.sid
            if ev.gid >= 0:
                args["gid"] = ev.gid
            if ev.bid >= 0:
                args["bid"] = ev.bid
            if ev.dep_n:
                args["ordinal"] = ev.dep_n
            events.append({"ph": "X", "pid": PID, "tid": tid,
                           "ts": ev.t0, "dur": 0, "cat": "issue",
                           "name": ev.tag and f"{ev.op}:{ev.tag}" or ev.op,
                           "args": args})
            issue_at[ev.eid] = (ev.t0, tid)
        elif ev.kind == "bubble":
            events.append({"ph": "X", "pid": PID, "tid": tid,
                           "ts": ev.t0, "dur": ev.t1 - ev.t0,
                           "cat": "bubble", "name": ev.tag or ev.op,
                           "args": {"eid": ev.eid}})
            issue_at[ev.eid] = (ev.t0, tid)
        elif ev.kind in ("mma", "tma"):
            cat = "wgmma" if ev.kind == "mma" else "tma"
            nm = ev.tag and f"{cat}:{ev.tag}" or ev.op
            args = {"eid": ev.eid, "cycles": ev.t1 - ev.t0}
            if ev.kind == "tma" and ev.fixed:
                args["fixed_cycles"] = ev.fixed
            if ev.sid >= 0:
                args["sid"] = ev.sid
            if ev.gid >= 0:
                args["gid"] = ev.gid
            events.append({"ph": "b", "pid": PID, "tid": tid, "ts": ev.t0,
                           "cat": cat, "id": ev.eid, "name": nm,
                           "args": args})
            events.append({"ph": "e", "pid": PID, "tid": tid, "ts": ev.t1,
                           "cat": cat, "id": ev.eid, "name": nm})
            src = issue_at.get(ev.src)
            if ev.src >= 0 and src is not None:
                s_ts, s_tid = src
                events.append({"ph": "s", "pid": PID, "tid": s_tid,
                               "ts": s_ts, "cat": "flow", "id": ev.eid,
                               "name": "launch"})
                events.append({"ph": "f", "pid": PID, "tid": tid,
                               "ts": ev.t0, "cat": "flow", "id": ev.eid,
                               "name": "launch", "bp": "e"})


def _counter(events, ts, name, key, value):
    events.append({"ph": "C", "pid": PID, "ts": ts, "name": name,
                   "args": {key: value}})


def _emit_counter_tracks(snk, events: List[Dict[str, Any]],
                         ring_track_limit: Optional[int]) -> None:
    for c, bw in snk.dram_bw_timeline():
        _counter(events, c, "DRAM bandwidth", "GB/s", round(bw, 2))
    for c, u in snk.dram_util_timeline():
        _counter(events, c, "DRAM util %", "%", _percent(u))
    for c, bw in snk.l2_bw_timeline():
        _counter(events, c, "L2 bandwidth", "GB/s", round(bw, 2))
    for c, r in snk.l2_hit_rate_timeline():
        _counter(events, c, "L2 hit %", "%", _percent(r))
    for c, u in snk.tc_util_timeline():
        _counter(events, c, "TensorCore busy %", "%", _percent(u))
    for c, n in snk.tma_inflight_timeline():
        _counter(events, c, "TMA in-flight lines", "lines", n)
    for c, n in zip(snk.cycles, snk.resident_ctas):
        _counter(events, c, "Resident CTAs", "ctas", n)
    for (cta, ring), series in sorted(snk.ring_occupancy.items()):
        if ring_track_limit is not None and cta >= ring_track_limit:
            continue
        nm = f"ring cta{cta}/{ring}"
        for c, depth in series:
            _counter(events, c, nm, "stages", depth)


def _emit_stall_tracks(trace, events: List[Dict[str, Any]],
                       window: int) -> None:
    from repro_torch.obs.counters import role_stall_timelines

    for role, buckets in sorted(role_stall_timelines(
            trace, window=window).items()):
        for bucket, wins in sorted(buckets.items()):
            nm = f"stall {role}:{bucket}"
            for w0 in sorted(wins):
                _counter(events, w0, nm, "cycles", round(wins[w0], 1))
