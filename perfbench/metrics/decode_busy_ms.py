"""Serve steps and model: card milliseconds of one decode step's operations
(kernels, memsets and copies; their durations summed): all the traced
segment's operations, every one a decode tick's, over its ticks (profiler)."""
from perfbench.readout import decode_segment

LAYER = "serve steps and model"


def read(name, r):
    seg = decode_segment(r)
    if not seg:
        return None
    ops, recs = seg
    return sum(o[1] - o[0] for o in ops) / len(recs) / 1e3
