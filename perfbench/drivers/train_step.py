"""Driver of the training cells: the step of ``trainer.make_train_step`` on a
``TrainState`` built from the benchmark's weights.

Traffic keys: ``batch``, ``seq``, ``remat``, ``microbatches``,
``optimizer`` (every field of ``OptConfig``), ``check_steps`` (the first
steps, driven in set-up and followed by the reference), ``feed_steps``
(batches made on the card in set-up, which the window cycles through),
``trace`` (``{"steps": n}``).

Set-up builds the one state the window trains (fp32 master weights drawn
from the seed, zero moments) and drives it through the first
``check_steps`` steps with the window's own call and feed, reading what
the check compares: each step's loss, the first gradient as the optimizer
took it (its first moment after one step over ``1 - beta1``) and each
leaf's change after the last of them. The window goes on from there.
"""
from __future__ import annotations

import gc
import time
from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np
import torch

from perfbench import counts, port, synthetic, weights
from perfbench.reference import dense_lm


@dataclass
class State:
    cfg: object
    run: object
    layout: dict
    state: object
    step_fn: object
    feed: torch.Tensor
    at: int = 0
    losses: List[float] = field(default_factory=list)
    first_grad: Dict[str, float] = field(default_factory=dict)
    change: Dict[str, float] = field(default_factory=dict)
    window_steps: List[dict] = field(default_factory=list)


def _paths(tree):
    return ["/".join(map(str, p)) for p, _ in weights.leaves_with_paths(tree)]


def _batch(st, i):
    """Step ``i``'s batch: the feed made in set-up, cycled through."""
    i %= st.feed.shape[0]
    return {"tokens": st.feed[i, 0], "labels": st.feed[i, 1]}


def _make(ctx, cfg, steps, device):
    t = ctx.traffic
    out = []
    for i in steps:
        tok, lab = synthetic.train_batch(ctx.seed, i, t["batch"], t["seq"], cfg.vocab_size)
        out.append({"tokens": torch.from_numpy(tok).to(device),
                    "labels": torch.from_numpy(lab).to(device)})
    return out


def setup(ctx):
    from repro_torch.models import api
    from repro_torch.train import optimizer as opt
    from repro_torch.train import trainer
    t = ctx.traffic
    cfg = port.config(ctx.conf)
    run = trainer.RunConfig(remat=t["remat"], microbatches=t["microbatches"],
                            opt=opt.OptConfig(**t["optimizer"]))
    layout = api.init(cfg, device="meta")
    params = weights.draw(layout, ctx.seed, ctx.device, requires_grad=True)
    state = trainer.TrainState(params=params, opt_state=opt.init(params), ef_error=None)
    feed = np.stack([np.stack(synthetic.train_batch(ctx.seed, i, t["batch"], t["seq"],
                                                    cfg.vocab_size))
                     for i in range(t["feed_steps"])])
    st = State(cfg=cfg, run=run, layout=layout, state=state,
               step_fn=trainer.make_train_step(cfg, run),
               feed=torch.from_numpy(feed).to(ctx.device))
    plant(ctx, st)
    b1 = t["optimizer"]["beta1"]
    for i in range(t["check_steps"]):
        st.state, m = st.step_fn(st.state, _batch(st, i))
        st.losses.append(float(m["loss"]))
        if i == 0:
            st.first_grad = {p: float(x.norm()) / (1 - b1) for p, x in
                             zip(_paths(st.state.params), _leaves(st.state.opt_state.m))}
    st.at = t["check_steps"]
    p0 = weights.draw(layout, ctx.seed, ctx.device)
    with torch.no_grad():
        st.change = {p: float((x - y).norm()) for p, x, y in
                     zip(_paths(params), _leaves(st.state.params), _leaves(p0))}
    del p0
    _sync(ctx)
    return st


def _leaves(tree):
    return [t for _, t in weights.leaves_with_paths(tree)]


def plant(ctx, st):
    """The fault ``ctx.fault`` planted in the program: ``state_unchanged``,
    an optimizer step that hands the state back as it was; ``half_batch``,
    a step on the first half of the batch's rows alone."""
    if ctx.fault is None:
        return
    from repro_torch.train import optimizer as opt
    if ctx.fault == "state_unchanged":
        def unchanged(cfg, params, grads, state):
            return params, state, {"grad_norm": opt.global_norm(grads),
                                   "lr": torch.zeros(())}
        ctx.undo.append((opt, "apply_updates", opt.apply_updates))
        opt.apply_updates = unchanged
    elif ctx.fault == "half_batch":
        inner = st.step_fn

        def half(state, batch):
            n = next(iter(batch.values())).shape[0] // 2
            return inner(state, {k: v[:n] for k, v in batch.items()})
        st.step_fn = half
    else:
        raise ValueError(f"the training driver plants no fault {ctx.fault!r}")


def _sync(ctx):
    if ctx.device.type == "cuda":
        torch.cuda.synchronize()


def _step(ctx, st, steps: List[dict]):
    t0 = time.perf_counter()
    with torch.profiler.record_function("pb.step"):
        st.state, m = st.step_fn(st.state, _batch(st, st.at))
        loss = float(m["loss"])                 # waits for the step
    t1 = time.perf_counter()
    st.at += 1
    steps.append({"t0": t0, "t1": t1, "finite": loss == loss and abs(loss) != float("inf")})


def window(ctx, st, seconds: float, instrumented: bool):
    steps: List[dict] = []
    start = time.perf_counter()
    while True:
        _step(ctx, st, steps)
        if steps[-1]["t1"] >= start + seconds:
            break
    # the window closes with the step that crossed ``seconds``: every step in
    # it is whole
    end = steps[-1]["t1"]
    st.window_steps = steps
    return {"start": start, "end": end, "seconds": end - start, "steps": steps}


def traced(ctx, st, profile):
    """``trace["steps"]`` steps, the optimizer's update inside a
    ``pb.optimizer`` range, synchronised before and after and timed by CUDA
    events (``optimizer_ms``)."""
    from repro_torch.train import optimizer as opt
    inner = opt.apply_updates
    opt_ms: List[float] = []

    def timed(*a, **k):
        _sync(ctx)
        if ctx.device.type == "cuda":
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
        with torch.profiler.record_function("pb.optimizer"):
            out = inner(*a, **k)
        if ctx.device.type == "cuda":
            ev[1].record()
            ev[1].synchronize()
            opt_ms.append(ev[0].elapsed_time(ev[1]))
        return out

    def body():
        steps: List[dict] = []
        for _ in range(ctx.traffic["trace"]["steps"]):
            _step(ctx, st, steps)
        return steps

    opt.apply_updates = timed
    try:
        trace, steps = profile(body)
    finally:
        opt.apply_updates = inner
    w = st.window_steps
    cycles = [b["t0"] - a["t0"] for a, b in zip(w, w[1:])]
    return {"trace": trace, "steps": steps, "optimizer_ms": opt_ms,
            "units": ctx.traffic["trace"]["steps"],
            "unit_wall_s": sum(cycles) / len(cycles) if cycles else None}


def end_to_end(ctx, rec):
    t = ctx.traffic
    n = sum(1 for s in rec["steps"] if s["t1"] <= rec["end"])
    return {"train_tok_s": n * t["batch"] * t["seq"] / rec["seconds"]}


def counts_of(ctx, rec):
    """(attempted, failed): the steps run in the window, and those whose loss
    was not finite."""
    return len(rec["steps"]), sum(1 for s in rec["steps"] if not s["finite"])


def window_flops(ctx, rec) -> float:
    t = ctx.traffic
    n = sum(1 for s in rec["steps"] if s["t1"] <= rec["end"])
    return n * counts.train_flops(ctx.conf, t["batch"], t["seq"])


def _gap(prog: Dict[str, float], ref: Dict[str, float], keep=None) -> float:
    """The worst leaf's gap between the program's norm and the reference's,
    over the larger of the reference's norm of that leaf and of the median leaf."""
    keys = [k for k in ref if keep is None or keep(k)]
    med = sorted(ref[k] for k in keys)[len(keys) // 2]
    return max(abs(prog[k] - ref[k]) / max(ref[k], med) for k in keys)


def check(ctx, st, rec):
    """Frees the program's state, then runs the float32 reference (and with
    ``ctx.control`` the fp8 control) through the same first steps from the
    same weights and batches: ``loss_rel_gap`` (the largest relative gap of
    a step's loss), ``first_grad_gap`` and ``change_gap`` (``_gap`` of the
    first gradient's and the change's norms; leaves whose reference
    gradient is under a thousandth of the median leaf's are left out of the
    change), ``nonfinite_steps`` of the window."""
    t = ctx.traffic
    losses, first, change = st.losses, st.first_grad, st.change
    nonfinite = sum(1 for s in rec["steps"] if not s["finite"])
    cfg, layout = st.cfg, st.layout
    st.state = st.step_fn = st.feed = None
    for mod, name, val in reversed(ctx.undo):
        setattr(mod, name, val)
    ctx.undo.clear()
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    batches = [(b["tokens"], b["labels"]) for b in _make(ctx, cfg, range(t["check_steps"]), ctx.device)]
    o = t["optimizer"]

    def readings(ref, losses_, first_, change_):
        med = sorted(ref["first_grad_norms"].values())[len(ref["first_grad_norms"]) // 2]
        moving = lambda k: ref["first_grad_norms"][k] >= 1e-3 * med
        return {"loss_rel_gap": max(abs(a - b) / abs(b) for a, b in zip(losses_, ref["losses"])),
                "first_grad_gap": _gap(first_, ref["first_grad_norms"]),
                "change_gap": _gap(change_, ref["change_norms"], moving)}

    ref = dense_lm.train_steps(ctx.conf, weights.draw(layout, ctx.seed, ctx.device), batches, o)
    out = {"nonfinite_steps": nonfinite, **readings(ref, losses, first, change),
           "host_loop_ms": ctx.host_loop_ms}
    if ctx.control:
        ctl = dense_lm.train_steps(ctx.conf, weights.draw(layout, ctx.seed, ctx.device),
                                   batches, o, "fp8")
        for k, v in readings(ref, ctl["losses"], ctl["first_grad_norms"], ctl["change_norms"]).items():
            out["control_" + k] = v
    return out

