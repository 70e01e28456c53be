"""Engine: the 95th percentile of each request's wait in the engine's queue,
from its submission to its admission (``Request.t_submit`` to ``t_admit``,
stamped by ``ServeEngine`` on ``time.perf_counter``), in ms, over the traced
run's window requests whose first token came in the window: the requests of
``ttft_p95_ms`` (host clock). The traced run synchronises each prefill, so
under this harness a request admitted after k others of its wave waits for
their k whole synchronised prefills: in a lockstep cell the reading is a
fixed multiple of ``prefill_ms.ttft`` (7 x at 8 slots), and it parts from
that only where the engine's admission does (another order, a per-slot
index, admission during decode). In a run without that synchronisation the
stamp is when the host began to enqueue the prefill, ahead of the card."""
from perfbench import bench

LAYER = "engine"


def read(name, r):
    rec = r.get("rec") or {}
    waits = []
    for f in rec.get("flights", []):
        a, s = getattr(f.req, "t_admit", None), getattr(f.req, "t_submit", None)
        if f.first is not None and f.first <= rec["end"] and a is not None and s is not None:
            waits.append((a - s) * 1e3)
    return bench.percentile(waits, 95) if waits else None
