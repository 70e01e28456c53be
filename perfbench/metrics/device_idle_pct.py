"""Device: share of the host's wall in which no operation ran on the card,
in percent: one minus the card's busy time a unit of work (a decode tick, a
wave, a training step: the union of the operations' intervals in the traced
segment over its units) over the host seconds a unit takes in the window,
which is not traced (from one unit's start to the next's). Tracing slows the
host, so the traced segment's own wall would overstate the idle time
(profiler and host clock)."""
LAYER = "device"


def read(name, r):
    tr, seg = r.get("trace"), r.get("seg") or {}
    if tr is None or not seg.get("units") or not seg.get("unit_wall_s"):
        return None
    busy = tr.busy_us() / 1e6
    return 100.0 * (1.0 - busy / seg["units"] / seg["unit_wall_s"]) if busy > 0 else None
