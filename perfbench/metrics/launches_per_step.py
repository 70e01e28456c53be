"""Serve steps and model: kernels the card runs for one decode step (memsets
and copies not counted): all the traced segment's kernels, every one a
decode tick's, over its ticks, rounded, since the count repeats exactly
from step to step (profiler)."""
from perfbench.readout import decode_segment
from perfbench.trace import is_kernel

LAYER = "serve steps and model"


def read(name, r):
    seg = decode_segment(r)
    if not seg:
        return None
    ops, recs = seg
    return float(round(sum(1 for o in ops if is_kernel(o[2])) / len(recs)))
