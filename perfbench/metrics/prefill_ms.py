"""Engine: synchronised host wall of one ``_prefill_slot`` call (one prompt's
prefill into the cache), the mean over every prefill of the traced run's
window (host clock)."""
from perfbench.readout import window_ticks

LAYER = "engine"


def read(name, r):
    ms = [x for t in window_ticks(r) for x in t["prefill_ms"]]
    return sum(ms) / len(ms) if ms else None
