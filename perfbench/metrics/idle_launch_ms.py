"""Device: the card's idle milliseconds a traced decode tick while the host
is still enqueuing that tick's step: the idle gaps between the card's
operations whose midpoints lie inside one of the program's
``repro.serve.decode`` ranges (``repro_torch/obs/spans.py``), summed over the
traced decode ticks and divided by their count (profiler; the card's
timestamps set against the host's within one session, the ranges' host
times alone, not the card time linked to them). Taken under the profiler,
which slows the host about 30 %: comparable parent against change on the same
harness. A program without the span reads nothing."""
from bisect import bisect_right

from perfbench.readout import decode_segment

LAYER = "device"
SPAN = "repro.serve.decode"


def read(name, r):
    seg = decode_segment(r)
    tr = r.get("trace")
    ranges = sorted((s, e) for s, e, n in tr.host if n == SPAN) if seg else []
    if not ranges or not seg[0]:
        return None
    starts = [s for s, _ in ranges]
    idle = 0.0
    for s, e in tr.gaps():
        m = (s + e) / 2
        i = bisect_right(starts, m) - 1      # the ranges of one thread do not overlap
        if i >= 0 and m <= ranges[i][1]:
            idle += e - s
    return idle / len(seg[1]) / 1e3
