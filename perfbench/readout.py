"""What the per-layer metric readers share: the traced decode ticks and the
window's instrumented ticks."""
from __future__ import annotations

from typing import List, Optional, Tuple


def decode_segment(r) -> Optional[Tuple[list, List[dict]]]:
    """``(card operations, tick records)`` of a traced segment of decode ticks
    alone (a chat cell's ``{"decode_ticks": n}``), where every operation
    traced is one of those ticks'; None for another segment."""
    tr, seg = r.get("trace"), r.get("seg")
    if tr is None or seg is None or not seg.get("ticks") or "decode_ticks" not in \
            r["ctx"].traffic.get("trace", {}):
        return None
    return tr.ops, seg["ticks"]


def window_ticks(r) -> List[dict]:
    """The instrumented window's ticks that ended inside it."""
    rec = r["rec"]
    return [t for t in rec.get("ticks", []) if t["t1"] <= rec["end"] and "prefill_ms" in t]
