"""The port's ``ServeEngine`` against the JAX engine: same weights (numpy, from
a seed), same prompts, greedy decoding, fp32 compute.

Token ids must be identical. That holds because in fp32 both sides compute the
same function to ~1e-5 on logits whose top two candidates lie much further
apart; with bf16 compute the two frameworks round at other places and an argmax
over near-ties can flip, so bf16 is held by a logits tolerance in
``test_torch_models.py`` instead. All requests of a scenario ask for the same
number of new tokens, so every slot retires on the same tick (the engine-wide
cache index is reset by each prefill, on both sides).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.serve import engine as jengine
from repro_torch import compat
from repro_torch.configs import registry as tregistry
from repro_torch.serve import decode as tdecode
from repro_torch.serve import engine as tengine

from test_torch_models import numpy_params, reference_mlp_follows_compute_dtype  # noqa: F401


def _engines(arch, slots, max_seq, seed):
    cj = dataclasses.replace(jregistry.get(arch).reduced(), compute_dtype="float32")
    ct = dataclasses.replace(tregistry.get(arch).reduced(), compute_dtype="float32")
    tree = numpy_params(cj, seed)
    ej = jengine.ServeEngine(cj, jax.tree.map(jnp.asarray, tree), slots=slots, max_seq=max_seq)
    et = tengine.ServeEngine(ct, compat.params_from_jax(ct, tree, device="cpu"), slots=slots,
                             max_seq=max_seq, device="cpu")
    return cj, ej, et


def _requests(mod, vocab, n, prompt_len, max_new, seed):
    rng = np.random.default_rng(seed)
    return [mod.Request(rid=i, prompt=rng.integers(0, vocab, prompt_len), max_new=max_new)
            for i in range(n)]


@pytest.mark.parametrize("arch,n,slots,prompt_len,max_new,max_seq,seed", [
    ("olmo-1b", 6, 3, 8, 4, 64, 0),         # the quickstart's serving scenario
    ("qwen2.5-3b", 5, 2, 6, 3, 32, 1),      # test_serve_engine_batched_requests
    ("llama3-8b", 4, 4, 5, 6, 16, 2),
])
def test_engine_tokens_identical_to_jax(arch, n, slots, prompt_len, max_new, max_seq, seed,
                                        reference_mlp_follows_compute_dtype):
    cfg, ej, et = _engines(arch, slots, max_seq, seed)
    rj = _requests(jengine, cfg.vocab_size, n, prompt_len, max_new, seed)
    rt = _requests(tengine, cfg.vocab_size, n, prompt_len, max_new, seed)
    for a, b in zip(rj, rt):
        ej.submit(a)
        et.submit(b)
    assert ej.run(max_steps=200) == et.run(max_steps=200) == []    # mirrored: always empty
    assert et.steps == ej.steps < 200
    for a, b in zip(rj, rt):
        assert len(b.out) == max_new and b.done
        assert b.out == a.out, (a.rid, a.out, b.out)
    assert et.cache["idx"] == int(ej.cache["idx"])
    assert et.straggler.slow_steps == 0
    np.testing.assert_array_equal(et.tokens.numpy(), np.asarray(ej.tokens))


def test_engine_mode_reference_gives_the_same_tokens():
    ct = dataclasses.replace(tregistry.get("qwen2.5-3b").reduced(), compute_dtype="float32")
    from repro_torch.models import api
    params = api.init(ct, 3, device="cpu")
    outs = []
    for mode in (None, "reference"):
        eng = tengine.ServeEngine(ct, params, slots=2, max_seq=24, device="cpu", mode=mode)
        reqs = _requests(tengine, ct.vocab_size, 3, 7, 4, 4)
        for r in reqs:
            eng.submit(r)
        eng.run()
        outs.append([r.out for r in reqs])
    assert outs[0] == outs[1]
    assert all(0 <= t < ct.vocab_size for out in outs[0] for t in out)


def test_engine_fixed_prompt_length_and_idle_step():
    ct = tregistry.get("olmo-1b").reduced()
    from repro_torch.models import api
    eng = tengine.ServeEngine(ct, api.init(ct, 0, device="cpu"), slots=2, max_seq=16,
                              device="cpu")
    assert eng.step() is False and eng.steps == 0          # nothing queued
    eng.submit(tengine.Request(rid=0, prompt=np.arange(4), max_new=2))
    with pytest.raises(ValueError, match="fixed-length"):
        eng.submit(tengine.Request(rid=1, prompt=np.arange(5), max_new=2))
    assert eng.cache["k"].dtype == torch.bfloat16          # the config's compute type
    assert eng.params["blocks"][0]["attn"]["wq"]["w"].dtype == torch.bfloat16
    assert eng.params["final_norm"] == {}                  # olmo: non-parametric norm
    assert eng.step() is True and eng.steps == 1 and eng.cache["idx"] == 5


def test_prefill_and_serve_steps_greedy_int32():
    ct = dataclasses.replace(tregistry.get("qwen2.5-3b").reduced(), compute_dtype="float32")
    cj = dataclasses.replace(jregistry.get("qwen2.5-3b").reduced(), compute_dtype="float32")
    from repro.serve import decode as jdecode
    tree = numpy_params(cj, 5)
    pj, pt = jax.tree.map(jnp.asarray, tree), compat.params_from_jax(ct, tree, device="cpu")
    toks = np.random.default_rng(6).integers(0, ct.vocab_size, (2, 9))
    # attn_chunk != 512 sends both sides through flash_ref with that chunk; the
    # block's MLP differs (bf16 in the reference) so only shapes and types are
    # compared on the prefill token, the cache at the bf16 tolerance
    nt, cache_t = tdecode.make_prefill_step(ct, max_seq=16, attn_chunk=4)(
        pt, {"tokens": torch.from_numpy(toks)})
    nj, cache_j = jdecode.make_prefill_step(cj, max_seq=16, attn_chunk=4)(
        pj, {"tokens": jnp.asarray(toks)})
    assert nt.dtype == torch.int32 and nt.shape == (2, 1) == tuple(nj.shape)
    np.testing.assert_allclose(cache_t["k"].numpy(), np.asarray(cache_j["k"]), atol=5e-2, rtol=5e-2)
    nxt, cache_t2 = tdecode.make_serve_step(ct)(pt, cache_t, nt)
    assert nxt.dtype == torch.int32 and nxt.shape == (2, 1) and cache_t2["idx"] == 10
    # cast_params as a string, as the reference takes it
    nb, cache_b = tdecode.make_prefill_step(ct, max_seq=16, cast_params="bfloat16")(
        pt, {"tokens": torch.from_numpy(toks)})
    assert nb.shape == (2, 1) and cache_b["k"].dtype == torch.float32


@pytest.mark.parametrize("samples", [
    [], [0.1], [0.1, 0.1, 0.1, 0.1], [0.05, 0.2, 0.1, 0.4, 0.3, 0.1, 0.15],
    list(np.random.default_rng(7).lognormal(-2, 0.5, 200)), [0.0, 0.0, 1.0]])
def test_straggler_policy_from_samples_equal(samples):
    for kw in ({}, {"percentile": 0.9, "factor_floor": 2.0}):
        a = jengine.StragglerPolicy.from_samples(samples, **kw)
        b = tengine.StragglerPolicy.from_samples(samples, **kw)
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
    pa, pb = jengine.StragglerPolicy(0.1, 2.0), tengine.StragglerPolicy(0.1, 2.0)
    for dt in (0.05, 0.25, 0.2, 1.0):
        assert pa.observe(dt) == pb.observe(dt)
    assert pa.slow_steps == pb.slow_steps == 2


def test_launcher_flags(capsys):
    from repro_torch.launch import serve
    assert serve.main(["--device", "cpu", "--requests", "3", "--slots", "2",
                       "--max-new", "2", "--prompt-len", "5", "--max-seq", "16"]) == 0
    out = capsys.readouterr().out
    assert "served 3 requests / 6 tokens of qwen2.5-3b-reduced on cpu in" in out
    cfg = tregistry.get("qwen2.5-3b").reduced()
    assert serve.decode_prediction(cfg, 2, 16) + "\n" in out
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if torch.cuda.is_available():
            raise RuntimeError("no CUDA device (skipped: a card is present)")
        serve.main(["--requests", "1"])
    # --full / --no-reduced really switch the reduced config off
    parse = serve.build_parser().parse_args
    assert parse([]).reduced is True and parse(["--reduced"]).reduced is True
    assert parse(["--full"]).reduced is False and parse(["--no-reduced"]).reduced is False
    assert parse([]).device == "cuda" and parse([]).arch == "qwen2.5-3b"


def test_launcher_decode_prediction_matches_reference():
    """The port's launcher line equals the reference launcher's arithmetic and format."""
    from repro.configs.llama3 import AttnWorkload
    from repro.core import analytical
    from repro.core.machine import H800
    from repro_torch.launch import serve
    cj = jregistry.get("qwen2.5-3b").reduced()
    w = AttnWorkload(name="decode", B=4, L=1, S=64, H_kv=cj.num_kv_heads or 4,
                     G=cj.q_group_size or 1, D=cj.head_dim)
    gpu = analytical.analyze(w, H800, kernel="splitkv_decode")
    want = (f"SimFA-H800 split-KV decode prediction: {gpu.latency*1e6:.1f} us "
            f"({gpu.bottleneck}-bound, "
            f"{gpu.dram_bytes/1e6:.2f} MB DRAM/step)")
    assert serve.decode_prediction(tregistry.get("qwen2.5-3b").reduced(), 4, 64) == want
