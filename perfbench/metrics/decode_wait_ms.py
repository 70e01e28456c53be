"""Engine: host milliseconds a decode tick waits for the card, the mean of
the program's ``repro.engine.wait`` ranges (``ServeEngine.step`` reading back
the step's tokens, ``repro_torch/obs/spans.py``) over the traced decode ticks
(profiler; the ranges' host durations alone). With ``decode_launch_ms`` it
says whether the host or the card paces the tick. Taken under the profiler,
which slows the host about 30 %: comparable parent against change on the same
harness, not with the untraced window's host times. A program without the
span reads nothing."""
from perfbench.readout import decode_segment

LAYER = "engine"
SPAN = "repro.engine.wait"


def read(name, r):
    if not decode_segment(r):
        return None
    us = [e - s for s, e, n in r["trace"].host if n == SPAN]
    return sum(us) / len(us) / 1e3 if us else None
