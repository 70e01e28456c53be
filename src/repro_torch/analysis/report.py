"""Text / JSON rendering for stall attribution and what-if sweeps."""
from __future__ import annotations

from dataclasses import asdict, is_dataclass
from typing import Dict, List, Sequence

from repro_torch.analysis.critical_path import BUCKETS, StallReport


def _fmt_row(cells: Sequence[str], widths: Sequence[int]) -> str:
    return "  ".join(str(c).rjust(w) for c, w in zip(cells, widths))


def render_stall_report(rep: StallReport, top: int = 0) -> str:
    """Per-warpgroup stall table; ``top`` limits to the N widest-idle WGs
    (0 = all). A totals row aggregates every warpgroup."""
    labels = sorted(rep.per_wg,
                    key=lambda l: -rep.meta[l]["idle"])
    if top:
        labels = labels[:top]
    head = ["warpgroup", "span", "busy", "idle", *BUCKETS]
    rows = [head]
    for lbl in labels:
        m, b = rep.meta[lbl], rep.per_wg[lbl]
        rows.append([lbl, m["span"], m["busy"], m["idle"],
                     *[b[k] for k in BUCKETS]])
    tot = rep.totals()
    mt = {k: sum(m[k] for m in rep.meta.values())
          for k in ("span", "busy", "idle")}
    rows.append(["TOTAL", mt["span"], mt["busy"], mt["idle"],
                 *[tot.get(k, 0) for k in BUCKETS]])
    widths = [max(len(str(r[i])) for r in rows) for i in range(len(head))]
    out = [_fmt_row(rows[0], widths),
           _fmt_row(["-" * w for w in widths], widths)]
    out += [_fmt_row(r, widths) for r in rows[1:]]
    out.append(f"(makespan {rep.makespan} cycles; idle buckets sum to idle "
               f"per warpgroup by construction)")
    return "\n".join(out)


def render_whatif_table(rows: List[Dict]) -> str:
    head = ["workload", "machine", "knobs", "base_us", "pred_us", "speedup"]
    table = [head]
    for r in rows:
        table.append([r["workload"], r["machine"], r["knobs_label"],
                      f"{r['base_us']:.1f}", f"{r['pred_us']:.1f}",
                      f"{r['speedup']:.2f}x"])
    widths = [max(len(str(row[i])) for row in table) for i in range(len(head))]
    out = [_fmt_row(table[0], widths),
           _fmt_row(["-" * w for w in widths], widths)]
    out += [_fmt_row(r, widths) for r in table[1:]]
    return "\n".join(out)


def render_critical_path(dag, path: List[int], summary: Dict[str, int],
                         max_nodes: int = 12) -> str:
    """Compressed critical-path listing: class totals + the longest hops."""
    total = max(sum(summary.values()), 1)
    out = ["critical path ({} nodes, {} cycles):".format(
        len(path), dag.events[path[-1]].t_done)]
    for k, v in sorted(summary.items(), key=lambda kv: -kv[1]):
        out.append(f"  {k:10s} {v:>10d} cycles  ({100.0 * v / total:5.1f}%)")
    out.append("  longest hops:")
    hops = sorted(path, key=lambda e: -(dag.events[e].t1 - dag.events[e].t0))
    for eid in hops[:max_nodes]:
        e = dag.events[eid]
        if e.t1 == e.t0:
            continue
        out.append(f"    {e.label:14s} {e.kind:6s} {e.tag or e.op:14s} "
                   f"[{e.t0}, {e.t1})  {e.t1 - e.t0} cycles")
    return "\n".join(out)


def save_json(path: str, obj, *, manifest=True) -> None:
    """Write ``obj`` as JSON.  By default the payload is stamped with an
    ``obs.manifest`` provenance manifest: dict payloads gain a
    ``"manifest"`` key (unless they already carry one), list payloads are
    wrapped as ``{"manifest": ..., "rows": [...]}``.  ``manifest=False``
    writes the object verbatim; ``manifest=<dict>`` stamps a caller-built
    manifest (e.g. a ``SimResult.manifest``) instead of a fresh one."""
    def default(o):
        if is_dataclass(o) and not isinstance(o, type):
            return asdict(o)
        raise TypeError(f"unserializable: {type(o)}")
    if manifest is not False:
        from repro_torch.obs.manifest import build_manifest
        stamp = manifest if isinstance(manifest, dict) else build_manifest()
        if isinstance(obj, dict):
            if "manifest" not in obj:
                obj = {**obj, "manifest": stamp}
        elif isinstance(obj, list):
            obj = {"manifest": stamp, "rows": obj}
    from repro_torch.utils.ioutil import atomic_write_json
    atomic_write_json(path, obj, indent=1, default=default)
