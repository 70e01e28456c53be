"""Pipeline Gantt chart extraction (paper Fig. 7).

The raw data now lives in the structured event trace
(:mod:`repro_torch.analysis.events`); this module is a *view* that flattens
``PipeEvent`` records back into ``(tag, start, end)`` intervals for the text
chart and external plotting.
"""
from __future__ import annotations

from typing import List, Tuple

# tag parsing lives in obs.labels (single source of truth for the
# cta{i}/{role} + {lane}:{label}:{tag} conventions); lane_of is
# re-exported here for back-compat
from repro_torch.obs.labels import label_of, lane_of, make_label  # noqa: F401
from repro_torch.obs.labels import split_gantt_tag

LANES = ("tma", "mma", "bubble")


def from_events(events) -> List[Tuple[str, int, int]]:
    """Flatten PipeEvents into the legacy gantt tuples (engine-occupancy
    intervals only: TMA jobs, tensor-core execution, softmax bubbles)."""
    out: List[Tuple[str, int, int]] = []
    for ev in events:
        if ev.kind == "mma":
            out.append((f"mma:{ev.label}:{ev.tag}", ev.t0, ev.t1))
        elif ev.kind == "tma":
            out.append((f"tma:{ev.label}:{ev.tag}", ev.t0, ev.t1))
        elif ev.kind == "bubble":
            out.append((f"bubble:{ev.label}", ev.t0, ev.t1))
    return out


def filter_sm(gantt: List[Tuple[str, int, int]], cta_ids=(0, 1)):
    """Keep intervals belonging to the given CTA ids (one SM's residents)."""
    keep = tuple(make_label(i, "") for i in cta_ids)
    return [g for g in gantt if any(k in g[0] for k in keep)]


def render_text(gantt: List[Tuple[str, int, int]], width: int = 100,
                t_max: int = 0) -> str:
    """ASCII Gantt: one row per (lane, warpgroup)."""
    if not gantt:
        return "(empty gantt)"
    t_end = t_max or max(e for _, _, e in gantt)
    rows = {}
    for tag, s, e in gantt:
        lane, wg, _ = split_gantt_tag(tag)
        key = f"{wg or '?'}:{lane}"
        rows.setdefault(key, []).append((s, e))
    out = []
    for key in sorted(rows):
        line = [" "] * width
        for s, e in rows[key]:
            a = min(width - 1, int(s / t_end * width))
            b = min(width, max(a + 1, int(e / t_end * width)))
            ch = {"tma": "=", "mma": "#", "bubble": "~"}.get(key.split(":")[-1], "*")
            for i in range(a, b):
                line[i] = ch
        out.append(f"{key:24s}|{''.join(line)}|")
    out.append(f"{'legend':24s}|= TMA   # WGMMA   ~ softmax bubbles; "
               f"0..{t_end} cycles|")
    return "\n".join(out)
