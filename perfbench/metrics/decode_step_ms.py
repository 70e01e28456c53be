"""Engine: host wall of a decode tick, ``ServeEngine.step`` less the
synchronised prefills inside it, the mean over every tick of the traced
run's window (host clock)."""
from perfbench.readout import window_ticks

LAYER = "engine"


def read(name, r):
    ticks = [t for t in window_ticks(r) if t["tokens"]]
    if not ticks:
        return None
    return sum((t["t1"] - t["t0"]) * 1e3 - sum(t["prefill_ms"]) for t in ticks) / len(ticks)
