"""The port's spans (``repro_torch.obs.spans``) and the engine's request stamps.

Under ``torch.profiler`` the engine's tick, the decode step, the model's
halves, the kernel seam and the train step are host ranges named
``repro.<layer>.<what>``, nested as the calls are; without a profiler every
span is one shared no-op. Spans change no arithmetic: tokens and losses are
the same with the profiler on and off. No range opens under grad inside the
model or the seam, so none lies inside an autograd backward node.
"""
import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import tree
from repro_torch.configs import registry
from repro_torch.models import api
from repro_torch.obs import spans
from repro_torch.serve import decode
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.train import optimizer as opt
from repro_torch.train import trainer

from torch_span_probe import TOL_US, clock_check

gpu = pytest.mark.gpu


def _cfg(arch="qwen2.5-3b"):
    return dataclasses.replace(registry.get(arch).reduced(), compute_dtype="float32")


def _requests(cfg, n, prompt_len=6, max_new=3, seed=0):
    rng = np.random.default_rng(seed)
    return [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, prompt_len), max_new=max_new)
            for i in range(n)]


def _engine(cfg, slots=2, device="cpu", seed=3):
    return ServeEngine(cfg, api.init(cfg, seed, device=device), slots=slots, max_seq=16,
                       device=device)


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return prof.events(), out


def _ancestors(e):
    names = []
    while e.cpu_parent is not None:
        e = e.cpu_parent
        names.append(e.name)
    return names


def _repro(events, name):
    return [e for e in events if e.name == spans.PREFIX + name]


def _inside(events, name, outer):
    """Every ``repro.<name>`` event lies inside a ``repro.<outer>`` one; how many."""
    got = _repro(events, name)
    assert got, name
    for e in got:
        assert spans.PREFIX + outer in _ancestors(e), (name, outer, _ancestors(e))
    return len(got)


def test_span_is_the_shared_noop_without_a_profiler():
    assert spans.span("engine.tick") is spans.NOOP
    assert spans.serving_span("model.attn") is spans.NOOP
    with torch.no_grad():
        assert spans.serving_span("model.attn") is spans.NOOP
    with profile(activities=[ProfilerActivity.CPU]):
        assert spans.span("engine.tick") is not spans.NOOP
        assert spans.serving_span("model.attn") is spans.NOOP       # grad on
        with torch.no_grad():
            assert spans.serving_span("model.attn") is not spans.NOOP


def test_an_engine_tick_nests_its_spans():
    cfg = _cfg()
    eng = _engine(cfg)
    for r in _requests(cfg, 2):
        eng.submit(r)
    events, _ = _profiled(eng.step)
    assert len(_repro(events, "engine.tick")) == 1
    assert _inside(events, "engine.prefill", "engine.tick") == 2
    assert _inside(events, "serve.decode", "engine.tick") == 1
    assert _inside(events, "engine.wait", "engine.tick") == 1
    assert _inside(events, "engine.emit", "engine.tick") == 1
    # the decode step's layers and their attention kernels; the prefills' too
    attn = _inside(events, "model.attn", "engine.tick")
    assert attn == 3 * cfg.num_layers
    assert _inside(events, "model.mlp", "engine.tick") == attn
    assert _inside(events, "kernels.flash_decode", "model.attn") == cfg.num_layers
    assert _inside(events, "kernels.flash_decode", "serve.decode") == cfg.num_layers
    assert _inside(events, "kernels.flash_attention", "engine.prefill") == 2 * cfg.num_layers
    # the readback is the engine's, not the decode step's
    assert spans.PREFIX + "serve.decode" not in _ancestors(_repro(events, "engine.wait")[0])


def test_the_prefill_steps_layers_are_spans():
    """The prefill step is no span of its own (the engine prefills through
    ``api.prefill``, inside ``engine.prefill``); its layers and kernels are."""
    cfg = _cfg()
    step = decode.make_prefill_step(cfg, max_seq=16)
    params = api.cast_params(cfg, api.init(cfg, 1, device="cpu"))
    toks = torch.as_tensor(np.arange(12).reshape(2, 6) % cfg.vocab_size, dtype=torch.int32)
    events, _ = _profiled(lambda: step(params, {"tokens": toks}))
    assert len(_repro(events, "model.attn")) == len(_repro(events, "model.mlp")) == cfg.num_layers
    assert _inside(events, "kernels.flash_attention", "model.attn") == cfg.num_layers
    assert {e.name for e in events if e.name.startswith(spans.PREFIX)} == {
        "repro.model.attn", "repro.model.mlp", "repro.kernels.flash_attention"}


def test_the_launcher_reports_the_stamps(capsys):
    from repro_torch.launch import serve
    reqs = [Request(rid=i, prompt=[0], t_submit=1.0, t_admit=1.0 + i, t_first=2.0 + i,
                    t_done=3.0 + 2 * i) for i in range(5)]
    assert serve.stamp_quantiles(reqs, "t_done", "request latency") == \
        "request latency p50 6000.0 ms, p95 9600.0 ms"
    assert serve.main(["--device", "cpu", "--requests", "3", "--slots", "2", "--max-new", "2",
                       "--prompt-len", "5", "--max-seq", "16"]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    for label in ("admission wait (host)", "time to first token", "request latency"):
        assert f"{label} p50 " in line and " ms, p95 " in line, (label, line)


def test_stamps_are_ordered_and_tokens_equal_with_the_profiler_on():
    cfg = _cfg()
    outs = []
    for traced in (False, True):
        eng = _engine(cfg)
        reqs = _requests(cfg, 3, max_new=3, seed=4)
        for r in reqs:
            eng.submit(r)
        if traced:
            _profiled(eng.run)
        else:
            eng.run()
        for r in reqs:
            assert r.done and r.t_submit <= r.t_admit <= r.t_first <= r.t_done
        # the third request waited in the queue for a free slot
        assert reqs[2].t_admit >= max(reqs[0].t_done, reqs[1].t_done)
        outs.append([r.out for r in reqs])
    assert outs[0] == outs[1]


def _train(cfg, traced):
    run = trainer.RunConfig(opt=opt.OptConfig(lr=1e-3, warmup_steps=2, total_steps=10))
    step = trainer.make_train_step(cfg, run)
    state = trainer.init_state(cfg, run, 5, device="cpu")
    rng = np.random.default_rng(6)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 9)), dtype=torch.int64)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if not traced:
        return None, step(state, batch)
    return _profiled(lambda: step(state, batch))


def test_a_train_step_nests_its_spans_and_none_under_a_backward_node():
    cfg = _cfg("olmo-1b")
    events, _ = _train(cfg, True)
    assert len(_repro(events, "train.step")) == 1
    assert _inside(events, "train.grads", "train.step") == 1
    assert _inside(events, "train.optimizer", "train.step") == 1
    assert any("FlashAttentionFnBackward" in e.name for e in events)
    for e in events:
        if e.name.startswith(spans.PREFIX):
            assert not any("FlashAttentionFnBackward" in a for a in _ancestors(e)), e.name
    # grad on: the model's and the seam's spans stay closed, recomputes included
    assert not [e for e in events if e.name.startswith(("repro.model.", "repro.kernels."))]


def test_loss_and_update_equal_with_the_profiler_on():
    cfg = _cfg("olmo-1b")
    _, (s0, m0) = _train(cfg, False)
    _, (s1, m1) = _train(cfg, True)
    assert torch.equal(m0["loss"], m1["loss"])
    for a, b in zip(tree.leaves(s0.params), tree.leaves(s1.params)):
        assert torch.equal(a, b)


class _Ev:
    """A raw profiler event, as ``prof.profiler.kineto_results.events()`` gives."""

    def __init__(self, name, dev, start_us, dur_us, corr=0, linked=0, thread=1):
        self._a = (name, dev, start_us * 1000, dur_us * 1000, corr, linked, thread)

    def name(self):
        return self._a[0]

    def device_type(self):
        return "DeviceType." + self._a[1]

    def start_ns(self):
        return self._a[2]

    def duration_ns(self):
        return self._a[3]

    def correlation_id(self):
        return self._a[4]

    def linked_correlation_id(self):
        return self._a[5]

    def start_thread_id(self):
        return self._a[6]

    def is_user_annotation(self):
        return False


def _kernel(n, launch_us, start_us, dur_us):
    """The launch call (correlation ``n``) and its kernel."""
    return [_Ev("cudaLaunchKernel", "CPU", launch_us, 3, corr=n, linked=100 + n),
            _Ev(f"k{n}", "CUDA", start_us, dur_us, corr=n, linked=100 + n)]


def _check(evs):
    from types import SimpleNamespace
    return clock_check(SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: evs))))


def test_clock_check_reads_both_sides_of_the_clock():
    evs = [_Ev(spans.PREFIX + "serve.decode", "CPU", 0, 100)]
    evs += _kernel(1, 10, 15, 20)          # card busy 15-35
    evs += _kernel(2, 40, 46, 4)           # launched after the card went idle: waited 35-46
    evs += _kernel(3, 20, 60, 10)          # queued since 20, yet idle 50-60: the card's own gap
    evs += _kernel(4, 300, 310, 5)         # the gap before it has its midpoint outside the range
    evs += [_Ev("k5", "CUDA", 80, 5, corr=5)]  # no launch in the profile: idle 70-80 unlinked
    c = _check(evs)
    assert (c["ranges"], c["kernels"], c["before_range"], c["before_launch"]) == (1, 3, 0, 0)
    assert c["lag_us_min"] == 5
    assert (c["gaps"], c["gap_us"], c["gaps_waited"], c["gap_us_waited"], c["gaps_unlinked"]) \
        == (3, 31.0, 1, 11.0, 1)
    evs += _kernel(6, 95, 90, 2)           # a kernel before its launch: the card's clock early
    c = _check(evs)
    assert c["before_launch"] == 1 and c["lag_us_min"] == -5


@gpu
def test_spans_share_the_profilers_clock_with_the_card():
    """A few decode ticks of a small model on the card under the profiler:
    through the profiler's links, no operation launched inside a
    ``repro.serve.decode`` range starts before that range opened, the card's
    clock agrees with the host's within a launch's latency from both sides,
    and the card's idle inside those ranges ends on operations launched after
    the gap opened."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; tests/torch_span_probe.py clock runs the check on a cell")
    cfg = dataclasses.replace(registry.get("qwen2.5-3b"), num_layers=2)
    eng = ServeEngine(cfg, api.cast_params(cfg, api.init(cfg, 0, device="cuda")), slots=4,
                      max_seq=256, device="cuda")
    for r in _requests(cfg, 4, prompt_len=128, max_new=16):
        eng.submit(r)
    for _ in range(4):                      # the prefills and four decode ticks, warm
        eng.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(6):
            eng.step()
        torch.cuda.synchronize()
    c = clock_check(prof)
    print("clock_check", c)
    assert c["ranges"] == 6 and c["kernels"] >= 6 * cfg.num_layers
    assert c["before_range"] == 0
    # the two clocks agree within a launch's latency, from both sides: no
    # operation reads more than TOL_US before its launch (the card's clock is
    # not that far early; a few read up to 2 us early), and the least lag is at
    # most TOL_US (it is not that far late)
    assert -TOL_US <= c["lag_us_min"] <= TOL_US
    # the idle counted in the ranges is the card waiting on launches
    assert c["gaps"] > 0 and c["gap_us_waited"] >= 0.9 * c["gap_us"] and not c["gaps_unlinked"]
