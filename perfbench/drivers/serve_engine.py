"""Driver of the serving cells: ``ServeEngine.submit`` / ``step`` under a
closed loop of clients in lockstep.

Traffic keys: ``clients`` (= the engine's slots), ``prompt_len``,
``max_new``, ``max_seq``, ``warm_new`` (new tokens of the warm-up wave),
``check_requests`` (how many finished requests the reference reads),
``trace`` (``{"waves": n}``: whole waves traced, or ``{"decode_ticks": n,
"skip": k}``: n decode ticks of a wave after its first k).

Each client sends a prompt of ``prompt_len`` seeded tokens, waits for its
``max_new`` tokens, and sends the next. The engine keeps one cache index
for all its slots (``serve/engine.py``), so it serves correctly only when
every slot is admitted in the same tick with equal lengths: the clients
run in waves, all admitted in one tick.

Set-up draws the weights (``weights.draw``, laid out and typed as
``api.cast_params(cfg, api.init(cfg, device="meta"))`` says, so the engine
casts nothing) and serves one warm-up wave of ``warm_new`` tokens.
"""
from __future__ import annotations

import gc
import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from perfbench import bench, counts, port, synthetic, weights
from perfbench.reference import dense_lm

WARM_RIDS = 1 << 19          # request ids of the warm-up wave (a stream apart)


@dataclass
class Flight:
    req: object
    submit: float
    seen: int = 0
    first: Optional[float] = None
    done: Optional[float] = None


@dataclass
class State:
    cfg: object
    params: dict
    eng: object
    next_rid: int = 0
    flights: List[Flight] = field(default_factory=list)     # the window's requests
    active: List[Flight] = field(default_factory=list)
    free: int = 0                                           # clients without a request
    instrument: Optional["_Instrument"] = None              # traced runs
    window_rec: Optional[dict] = None                       # traced runs


def _request(ctx, st, rid):
    from repro_torch.serve.engine import Request
    t = ctx.traffic
    prompt = synthetic.tokens(ctx.seed, rid, 1, t["prompt_len"], st.cfg.vocab_size)[0]
    return Request(rid=rid, prompt=prompt, max_new=t["max_new"])


def setup(ctx):
    from repro_torch.models import api
    from repro_torch.serve.engine import ServeEngine
    t = ctx.traffic
    cfg = port.config(ctx.conf)
    layout = api.cast_params(cfg, api.init(cfg, device="meta"))
    params = weights.draw(layout, ctx.seed, ctx.device)
    eng = ServeEngine(cfg, params, slots=t["clients"], max_seq=t["max_seq"], device=ctx.device)
    st = State(cfg=cfg, params=params, eng=eng, free=t["clients"])
    plant(ctx, st)
    for i in range(t["clients"]):
        r = _request(ctx, st, WARM_RIDS + i)
        r.max_new = t["warm_new"]
        eng.submit(r)
    while eng.queue or any(eng.active):
        eng.step()
    _sync(ctx)
    return st


def plant(ctx, st):
    """The fault ``ctx.fault`` planted in the program: ``token_altered`` adds
    one to the token each request is first served, where the decode step
    produces it."""
    if ctx.fault is None:
        return
    if ctx.fault != "token_altered":
        raise ValueError(f"the serving driver plants no fault {ctx.fault!r}")
    inner, first = st.eng._decode, ctx.traffic["prompt_len"]

    def altered(params, cache, tokens):
        at = cache["idx"]
        nxt, cache = inner(params, cache, tokens)
        if at == first:
            nxt = (nxt + 1) % st.cfg.vocab_size
        return nxt, cache

    st.eng._decode = altered


def _sync(ctx):
    if ctx.device.type == "cuda":
        torch.cuda.synchronize()


class _Instrument:
    """Host ranges around the engine's prefill and decode calls, each prefill
    synchronised and timed, each decode's cache length noted (traced runs)."""

    def __init__(self, ctx, st):
        self.prefill_ms: List[float] = []
        self.clens: List[int] = []
        eng = st.eng
        inner_prefill, inner_decode = eng._prefill_slot, eng._decode

        def prefill(slot, req):
            _sync(ctx)
            t0 = time.perf_counter()
            with torch.profiler.record_function("pb.prefill"):
                inner_prefill(slot, req)
            _sync(ctx)
            self.prefill_ms.append((time.perf_counter() - t0) * 1e3)

        def decode(params, cache, tokens):
            self.clens.append(int(cache["idx"]) + 1)
            with torch.profiler.record_function("pb.decode"):
                return inner_decode(params, cache, tokens)

        eng._prefill_slot, eng._decode = prefill, decode


def _tick(ctx, st, submit: bool, instrument: Optional[_Instrument], ticks: List[dict]):
    """One engine tick, after sending the free clients' next requests."""
    eng = st.eng
    if submit:
        for _ in range(st.free):
            r = _request(ctx, st, st.next_rid)
            st.next_rid += 1
            f = Flight(req=r, submit=time.perf_counter())
            eng.submit(r)
            st.active.append(f)
            st.flights.append(f)
        st.free = 0
    n_pre = len(instrument.prefill_ms) if instrument else 0
    t0 = time.perf_counter()
    with torch.profiler.record_function("pb.tick"):
        eng.step()
    t1 = time.perf_counter()
    tokens, still = 0, []
    for f in st.active:
        k = len(f.req.out)
        if k > f.seen:
            tokens += k - f.seen
            f.seen = k
            if f.first is None:
                f.first = t1
        if f.req.done:
            f.done = t1
            st.free += 1
        else:
            still.append(f)
    st.active = still
    tick = {"t0": t0, "t1": t1, "tokens": tokens}
    if instrument:
        tick["prefill_ms"] = instrument.prefill_ms[n_pre:]
        tick["clen"] = instrument.clens[-1]
    ticks.append(tick)
    return tick


def window(ctx, st, seconds: float, instrumented: bool):
    inst = _Instrument(ctx, st) if instrumented else None
    ticks: List[dict] = []
    start = time.perf_counter()
    while _tick(ctx, st, True, inst, ticks)["t1"] < start + seconds:
        pass
    # the window closes with the tick that crossed ``seconds``: every tick in
    # it is whole
    end = ticks[-1]["t1"]
    rec = {"start": start, "end": end, "seconds": end - start, "ticks": ticks,
           "flights": list(st.flights)}
    if inst:
        # finish the wave in flight, so that a traced segment starts a wave
        while st.active:
            _tick(ctx, st, False, inst, [])
        st.instrument = inst
        st.window_rec = rec
    return rec


def traced(ctx, st, profile):
    """The traced segment, run through ``profile(body)``: ``{"waves": n}``, n whole
    waves; ``{"decode_ticks": n, "skip": k}``, after k untraced ticks of a
    new wave, n of its decode ticks. Returns the trace and the full run's
    tick records."""
    spec = ctx.traffic["trace"]
    inst = st.instrument

    def run_ticks(out, n=None, submit=True):
        first = True
        while st.active or first:
            out.append(_tick(ctx, st, submit and first, inst, []))
            first = False
            if n is not None and len(out) >= n:
                break
        return out

    if "waves" in spec:
        def body():
            ticks = []
            for _ in range(spec["waves"]):
                run_ticks(ticks)
            return ticks
    else:
        run_ticks([], spec["skip"])

        def body():
            return run_ticks([], spec["decode_ticks"], submit=False)
    trace, ticks = profile(body)
    while st.active:
        _tick(ctx, st, False, inst, [])
    if "waves" in spec:
        units, wall = spec["waves"], _wave_wall(st.window_rec)
    else:
        units, wall = spec["decode_ticks"], _decode_tick_wall(st.window_rec)
    return {"trace": trace, "ticks": ticks, "units": units, "unit_wall_s": wall}


def _cycles(rec, keep):
    """Host seconds from the start of each kept tick of the window to the
    start of the next tick."""
    t = rec["ticks"]
    return [b["t0"] - a["t0"] for a, b in zip(t, t[1:]) if keep(a, b)]


def _decode_tick_wall(rec):
    """The mean host seconds of a window tick without a prefill, to the next."""
    c = _cycles(rec, lambda a, b: not a["prefill_ms"])
    return sum(c) / len(c) if c else None


def _wave_wall(rec):
    """The mean host seconds of a whole wave of the window, from the start
    of its first tick (the one with its prefills) to the next wave's."""
    starts = [t["t0"] for t in rec["ticks"] if t["prefill_ms"]]
    c = [b - a for a, b in zip(starts, starts[1:])]
    return sum(c) / len(c) if c else None


def end_to_end(ctx, rec):
    tok = sum(t["tokens"] for t in rec["ticks"] if t["t1"] <= rec["end"])
    ttft = [(f.first - f.submit) * 1e3 for f in rec["flights"]
            if f.first is not None and f.first <= rec["end"]]
    out = {"gen_tok_s": tok / rec["seconds"]}
    if ttft:
        out["ttft_p95_ms"] = bench.percentile(ttft, 95)
    return out


def _finished(rec):
    """The requests that the window finished."""
    return [f for f in rec["flights"] if f.done is not None and f.done <= rec["end"]]


def _bad(ctx, done) -> int:
    """Of the finished requests ``done``, those that came back with the wrong
    number of tokens or a token out of the vocabulary."""
    n, V = ctx.traffic["max_new"], ctx.conf["vocab_size"]
    return sum(1 for f in done if len(f.req.out) != n or not all(0 <= x < V for x in f.req.out))


def counts_of(ctx, rec):
    """(attempted, failed): the requests sent in the window, and those of
    them that it finished and that did not come back whole."""
    return len(rec["flights"]), _bad(ctx, _finished(rec))


def window_flops(ctx, rec) -> float:
    """Model FLOPs of the ticks completed in the window (traced runs)."""
    c, S = ctx.conf, ctx.traffic["prompt_len"]
    total = 0.0
    for t in rec["ticks"]:
        if t["t1"] <= rec["end"]:
            total += len(t["prefill_ms"]) * counts.prefill_flops(c, S)
            total += counts.decode_flops(c, t["tokens"], t["clen"])
    return total


def check(ctx, st, rec):
    """Frees the engine, then holds a sample of the requests finished in the
    window to the float32 reference: the widest gap of a served token's
    logit below the reference's best (``logit_gap_max``), and the requests
    that came back with the wrong number of tokens or a token out of the
    vocabulary (``bad_requests``)."""
    t = ctx.traffic
    done = _finished(rec)
    bad = _bad(ctx, done)
    st.eng = None
    st.active = []
    st.instrument = st.window_rec = None
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    rng = np.random.default_rng(synthetic.fold_seed(ctx.seed) + 1)
    order = sorted(range(len(done)), key=lambda i: -(len(done[i].req.prompt) + len(done[i].req.out)))
    pick = order[:1] + sorted(rng.choice(order[1:], size=min(t["check_requests"], len(done)) - 1,
                                         replace=False).tolist()) if done else []
    sample = [(done[i].req.prompt.tolist(), list(done[i].req.out)) for i in pick]
    walls = sorted((b["t0"] - a["t0"]) * 1e3 for a, b in zip(rec["ticks"], rec["ticks"][1:])
                   if a["tokens"] and b["t1"] <= rec["end"] and a["t1"] - a["t0"] < 0.1)
    readings = {"bad_requests": bad, "requests_checked": len(sample),
                "tokens_checked": sum(len(s) for _, s in sample),
                "host_loop_ms": ctx.host_loop_ms}
    if walls:
        readings.update({f"decode_tick_ms_p{q}": walls[min(len(walls) - 1, len(walls) * q // 100)]
                         for q in (10, 50, 90)})
    if not sample:
        readings["logit_gap_max"] = None
        return readings
    ref = dense_lm.served_gaps(ctx.conf, st.params, sample, control=ctx.control)
    readings["logit_gap_max"] = max(max(g) for g in ref["gaps"])
    if ctx.control:
        readings["control_logit_gap_max"] = max(max(g) for g in ref["control_gaps"])
    return readings
