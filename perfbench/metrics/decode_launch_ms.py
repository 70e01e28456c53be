"""Serve steps and model: host milliseconds to enqueue one decode step, the
mean of the program's ``repro.serve.decode`` ranges (``make_serve_step``'s
step, ``repro_torch/obs/spans.py``) over the traced decode ticks (profiler;
the ranges' host durations alone). Taken under the profiler, which slows the
host about 30 %: comparable parent against change on the same harness, not
with the untraced window's host times. A program without the span reads
nothing."""
from perfbench.readout import decode_segment

LAYER = "serve steps and model"
SPAN = "repro.serve.decode"


def read(name, r):
    if not decode_segment(r):
        return None
    us = [e - s for s, e, n in r["trace"].host if n == SPAN]
    return sum(us) / len(us) / 1e3 if us else None
