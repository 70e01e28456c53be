"""The port's Mamba2 block (``models/mamba.py``) and hybrid family (zamba2)
against the JAX package's: ``mamba_apply`` on its chunked and one-token paths,
the chunked-against-recurrent self-check, the model's forward, prefill cache and
decode, the engine's greedy tokens, ``cast_params``, the parameter hand-over,
the step-1 gradients and the optimizer's decay rule.

Weights and inputs are made by numpy from a seed in the JAX layout and handed
to both sides (``repro_torch.compat``); ``A_log``, ``D``, ``dt_bias`` and
``conv_b`` are the JAX init's own values, so the decays are the model's. The
model runs at reduced width with 2 prologue layers and 2 groups of 2 Mamba2
layers (so that no stacked dim is 1), and ``ssm_chunk`` 8 at 20 tokens: the
chunked scan takes three chunks, the last one padded.
"""
import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.data.synthetic import token_batch
from repro.models import api as japi
from repro.models import mamba as jmamba
from repro.serve import engine as jengine
from repro.train import optimizer as jopt
from repro.train import trainer as jtrainer
from repro_torch import compat, tree
from repro_torch.configs import registry as tregistry
from repro_torch.models import api as tapi
from repro_torch.models import mamba as tmamba
from repro_torch.models import transformer as ttransformer
from repro_torch.serve import engine as tengine
from repro_torch.train import optimizer as topt
from repro_torch.train import trainer as ttrainer

from test_torch_models import (BF16, F32, numpy_params,  # noqa: F401
                               reference_mlp_follows_compute_dtype)
from test_torch_moe import F32_GRADS, _close_but_bf16_flips

ARCH = "zamba2-7b"
DEPTH = dict(hybrid_prologue=2, hybrid_groups=2, hybrid_mamba_per_group=2, ssm_chunk=8)
# the block alone: fp32 leaves the order of summation (the cumulative sums and
# the three-operand products are contracted in other orders); bf16 rounds the
# projections' outputs, which both sides do at the same places
MAMBA_TOL = {"float32": dict(atol=1e-5, rtol=1e-5), "bfloat16": dict(atol=2e-2, rtol=2e-2)}
MAMBA_KEYS = ("A_log", "D", "dt_bias", "conv_b")


def _cfgs(dtype="float32", **kw):
    cj = dataclasses.replace(jregistry.get(ARCH).reduced(), compute_dtype=dtype, **DEPTH, **kw)
    ct = dataclasses.replace(tregistry.get(ARCH).reduced(), compute_dtype=dtype, **DEPTH, **kw)
    return cj, ct


def hybrid_numpy_params(cj, seed):
    """``numpy_params``, with the four Mamba2 leaves the JAX init sets by formula
    (the same in every layer) taken from the JAX init of one layer."""
    tree_np = numpy_params(cj, seed)
    init = jmamba.mamba_init(jax.random.PRNGKey(0), cj)
    for part in ("prologue", "groups"):
        leaves = tree_np[part]["mamba"]
        for k in MAMBA_KEYS:
            leaves[k] = np.broadcast_to(np.asarray(init[k]), leaves[k].shape).copy()
    return tree_np


def _both_params(cj, ct, seed):
    tree_np = hybrid_numpy_params(cj, seed)
    return tree_np, jax.tree.map(jnp.asarray, tree_np), compat.params_from_jax(
        ct, tree_np, device="cpu")


def _close(t, j, tol, what=""):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32), **tol,
                               err_msg=what)


def _restack(states):
    """Nested lists of {"conv", "ssm"} states as the JAX cache's stacked leaves."""
    if isinstance(states, dict):
        return {k: v.numpy() for k, v in states.items()}
    items = [_restack(s) for s in states]
    return {k: np.stack([x[k] for x in items]) for k in items[0]}


# ---------------------------------------------------------------------------
# the Mamba2 block
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("path", ["chunked", "chunked_from_a_state", "one_token"])
def test_mamba_apply_matches_jax(dtype, path):
    """Outputs and both state leaves; 20 tokens in chunks of 8, or one token."""
    cj, ct = _cfgs(dtype)
    _, pj, pt = _both_params(cj, ct, 0)
    pj = jax.tree.map(lambda a: a[0], pj["prologue"]["mamba"])
    pt = pt["prologue"][0]["mamba"]
    rng = np.random.default_rng(1)
    B, S = 2, (1 if path == "one_token" else 20)
    x = rng.standard_normal((B, S, ct.d_model)).astype(np.float32)
    sj = st = None
    if path != "chunked":
        zero = tmamba.mamba_state_init(ct, B, device="cpu")
        s_np = {k: (0.5 * rng.standard_normal(v.shape)).astype(np.float32)
                for k, v in zero.items()}
        sj = {k: jnp.asarray(v) for k, v in s_np.items()}
        st = {k: torch.from_numpy(v) for k, v in s_np.items()}
    yj, nj = jmamba.mamba_apply(pj, jnp.asarray(x).astype(dtype), cj, state=sj)
    yt, nt = tmamba.mamba_apply(pt, torch.from_numpy(x).to(getattr(torch, dtype)), ct, state=st)
    assert yt.dtype == getattr(torch, dtype) and yt.shape == (B, S, ct.d_model)
    assert nt["conv"].dtype == nt["ssm"].dtype == torch.float32
    _close(yt, yj, MAMBA_TOL[dtype], "y")
    _close(nt["ssm"], nj["ssm"], MAMBA_TOL[dtype], "ssm")
    _close(nt["conv"], nj["conv"], MAMBA_TOL[dtype], "conv")


@pytest.mark.parametrize("chunk", [128, 8])
def test_mamba_chunked_matches_recurrent(chunk):
    """The reference's self-check on the port: the chunked SSD equals the
    step-by-step recurrence (same state, same output), in one chunk and in
    two chunks of 8, the second padded."""
    ct = dataclasses.replace(tregistry.get(ARCH).reduced(), ssm_chunk=chunk)
    p = tmamba.mamba_init(torch.Generator().manual_seed(0), ct)
    B, S = 2, 12
    x = 0.5 * torch.randn((B, S, ct.d_model), generator=torch.Generator().manual_seed(1))
    y_chunk, st_chunk = tmamba.mamba_apply(p, x, ct)
    st = tmamba.mamba_state_init(ct, B, device="cpu")
    ys = []
    for t in range(S):
        y_t, st = tmamba.mamba_apply(p, x[:, t:t + 1], ct, state=st)
        ys.append(y_t)
    np.testing.assert_allclose(torch.cat(ys, 1).float().numpy(), y_chunk.float().numpy(),
                               atol=2e-2, rtol=2e-2)
    np.testing.assert_allclose(st["ssm"].numpy(), st_chunk["ssm"].numpy(), atol=1e-3, rtol=1e-3)
    np.testing.assert_array_equal(st["conv"].numpy(), st_chunk["conv"].numpy())


# ---------------------------------------------------------------------------
# the hybrid model: forward, prefill cache and decode
# ---------------------------------------------------------------------------

def _hybrid_parity(dtype, tol):
    cj, ct = _cfgs(dtype)
    _, pj, pt = _both_params(cj, ct, 2)
    rng = np.random.default_rng(3)
    B, S, S_max = 2, 20, 32
    toks = rng.integers(0, ct.vocab_size, (B, S + 1))
    bj, bt = {"tokens": jnp.asarray(toks[:, :S])}, {"tokens": torch.from_numpy(toks[:, :S])}

    hj, auxj = japi.forward_hidden(cj, pj, bj, remat="none")
    with torch.no_grad():
        ht, auxt = tapi.forward_hidden(ct, pt, bt, remat="none")
    assert ht.shape == (B, S, ct.d_model) and auxt == auxj == 0.0
    _close(ht, hj, tol, "forward hidden")

    hj, cache_j = japi.prefill(cj, pj, bj, max_seq=S_max, remat="none")
    with torch.no_grad():
        ht, cache_t = tapi.prefill(ct, pt, bt, max_seq=S_max)
    assert cache_t["idx"] == S == int(cache_j["idx"])
    _close(ht, hj, tol, "prefill hidden")
    _close(tapi.unembed(ct, pt, ht[:, -1:]), japi.unembed(cj, pj, hj[:, -1:]), tol, "logits")

    def caches_close(cache_t, cache_j, when):
        for part in ("prologue", "groups"):
            got = _restack(cache_t[part])
            for k in ("conv", "ssm"):
                assert got[k].dtype == np.float32
                assert got[k].shape == cache_j[part][k].shape, (when, part, k)
                _close(torch.from_numpy(got[k]), cache_j[part][k], tol, f"{when} {part} {k}")
        for k in ("attn_k", "attn_v"):
            assert cache_t[k].shape == (ct.hybrid_groups, B, S_max, ct.num_kv_heads, ct.head_dim)
            _close(cache_t[k], cache_j[k], tol, f"{when} {k}")

    caches_close(cache_t, cache_j, "prefill")
    lj, cache_j2 = japi.decode(cj, pj, cache_j, jnp.asarray(toks[:, S:]))
    with torch.no_grad():
        lt, cache_t2 = tapi.decode(ct, pt, cache_t, torch.from_numpy(toks[:, S:]))
    assert cache_t2 is cache_t and cache_t["idx"] == S + 1      # updated in place
    assert lt.shape == (B, 1, ct.vocab_size)
    _close(lt, lj, tol, "decode logits")
    caches_close(cache_t, cache_j2, "decode")


def test_forward_prefill_cache_and_decode_match_jax_fp32(reference_mlp_follows_compute_dtype):
    _hybrid_parity("float32", F32)


def test_forward_prefill_cache_and_decode_match_jax_bf16():
    _hybrid_parity("bfloat16", BF16)


def test_decode_matches_full_forward():
    """As the JAX package's test of the same name: bf16 compute."""
    _, ct = _cfgs("bfloat16")
    pt = tapi.init(ct, 0, device="cpu")
    B, S = 2, 20
    toks = torch.from_numpy(np.random.default_rng(4).integers(0, ct.vocab_size, (B, S + 1)))
    with torch.no_grad():
        hidden, _ = tapi.forward_hidden(ct, pt, {"tokens": toks}, remat="none")
        logits_full = tapi.unembed(ct, pt, hidden[:, -1:])
        _, cache = tapi.prefill(ct, pt, {"tokens": toks[:, :S]}, max_seq=S + 8)
        logits_dec, _ = tapi.decode(ct, pt, cache, toks[:, S:S + 1])
    np.testing.assert_allclose(logits_dec.float().numpy(), logits_full.float().numpy(),
                               atol=2e-2, rtol=2e-2)


def test_engine_tokens_identical_to_jax(reference_mlp_follows_compute_dtype):
    """fp32 greedy tokens of the port's ServeEngine and the JAX one: 5 requests
    over 2 slots, so slots are refilled and the states spliced into them."""
    cj, ct = _cfgs("float32")
    tree_np, pj, pt = _both_params(cj, ct, 5)
    ej = jengine.ServeEngine(cj, pj, slots=2, max_seq=32)
    et = tengine.ServeEngine(ct, pt, slots=2, max_seq=32, device="cpu")
    rng = np.random.default_rng(6)
    prompts = rng.integers(0, ct.vocab_size, (5, 11))
    rj = [jengine.Request(rid=i, prompt=p, max_new=4) for i, p in enumerate(prompts)]
    rt = [tengine.Request(rid=i, prompt=p, max_new=4) for i, p in enumerate(prompts)]
    for a, b in zip(rj, rt):
        ej.submit(a)
        et.submit(b)
    ej.run(max_steps=100)
    et.run(max_steps=100)
    assert et.steps == ej.steps < 100
    for a, b in zip(rj, rt):
        assert len(b.out) == 4 and b.out == a.out, (a.rid, a.out, b.out)
    for part in ("prologue", "groups"):
        for k, v in _restack(et.cache[part]).items():
            np.testing.assert_allclose(v, np.asarray(ej.cache[part][k]), **F32)


# ---------------------------------------------------------------------------
# cast_params, the hand-over, the trainer and the optimizer
# ---------------------------------------------------------------------------

FP32_LEAVES = ("conv_w", "conv_b", "A_log", "D", "dt_bias")


def test_cast_params_keeps_the_mamba_leaves_fp32(monkeypatch):
    """bf16 compute: the same hidden states and logits with and without the
    cast, the Mamba2 leaves mamba_apply computes with in fp32 still fp32. With
    the norm scales and the router alone kept (the rule before the hybrid was
    ported) the numbers move, with no error: the fault this test is for."""
    cj, ct = _cfgs("bfloat16")
    _, _, pt = _both_params(cj, ct, 7)
    layers = pt["prologue"] + [blk for g in pt["groups"] for blk in g]
    cast = tapi.cast_params(ct, pt)
    for blk in cast["prologue"] + [blk for g in cast["groups"] for blk in g]:
        m = blk["mamba"]
        assert all(m[k].dtype == torch.float32 for k in FP32_LEAVES)
        assert m["norm"]["scale"].dtype == blk["norm"]["scale"].dtype == torch.float32
        assert m["in_proj"]["w"].dtype == m["out_proj"]["w"].dtype == torch.bfloat16
    assert cast["shared_attn"]["attn"]["wq"]["w"].dtype == torch.bfloat16
    assert cast["shared_attn"]["attn_norm"]["scale"].dtype == torch.float32
    assert cast["emb"]["table"].dtype == torch.bfloat16
    assert len(layers) == 2 + 2 * 2

    toks = torch.from_numpy(np.random.default_rng(8).integers(0, ct.vocab_size, (1, 20)))

    def run(params):
        with torch.no_grad():
            h, c = tapi.prefill(ct, params, {"tokens": toks}, max_seq=24)
            lg, _ = tapi.decode(ct, params, c, toks[:, -1:])
        return h, lg

    h1, l1 = run(pt)
    h2, l2 = run(cast)
    assert torch.equal(h1, h2) and torch.equal(l1, l2)
    monkeypatch.setattr(ttransformer, "_FP32_KEYS",
                        ("attn_norm", "mlp_norm", "final_norm", "router", "norm"))
    h3, _ = run(tapi.cast_params(ct, pt))
    assert not torch.equal(h1, h3)


def test_compat_round_trip_of_the_nested_tree():
    """prologue stacked on 1 dim, groups on 2 (a list of lists here),
    shared_attn not stacked; the port's own init restacks to the JAX shapes."""
    cj, ct = _cfgs()
    tree_np = hybrid_numpy_params(cj, 9)
    pt = compat.params_from_jax(ct, tree_np, device="cpu")
    assert len(pt["prologue"]) == 2 and [len(g) for g in pt["groups"]] == [2, 2]
    assert pt["groups"][1][0]["mamba"]["in_proj"]["w"].shape == \
        tree_np["groups"]["mamba"]["in_proj"]["w"].shape[2:]
    np.testing.assert_array_equal(pt["groups"][1][0]["mamba"]["conv_w"].numpy(),
                                  tree_np["groups"]["mamba"]["conv_w"][1, 0])
    np.testing.assert_array_equal(pt["shared_attn"]["attn"]["wo"]["w"].numpy(),
                                  tree_np["shared_attn"]["attn"]["wo"]["w"])
    back = compat.params_to_jax(ct, pt)
    assert jax.tree.structure(back) == jax.tree.structure(tree_np)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree_np)):
        np.testing.assert_array_equal(a, b)
    shapes = jax.eval_shape(lambda: japi.init(cj, jax.random.PRNGKey(0)))
    mine = compat.params_to_jax(ct, tapi.init(ct, 0, device="cpu"))
    assert jax.tree.structure(mine) == jax.tree.structure(shapes)
    for a, s in zip(jax.tree.leaves(mine), jax.tree.leaves(shapes)):
        assert a.shape == s.shape and a.dtype == np.float32


@pytest.fixture(scope="module")
def jax_grads():
    """Step-1 loss and gradients of the JAX package at fp32 (its MLP at fp32 too)."""
    from repro.models import layers as jl
    cj, _ = _cfgs("float32")
    tree_np = hybrid_numpy_params(cj, 10)
    b = token_batch(cj, batch=2, seq=20, step=0)
    mlp = jl.apply_mlp
    jl.apply_mlp = partial(mlp, dtype=jnp.float32)
    try:
        (lj, _), gj = jax.value_and_grad(
            jtrainer.make_loss_fn(cj, jtrainer.RunConfig(remat="none")), has_aux=True)(
                jax.tree.map(jnp.asarray, tree_np), {k: jnp.asarray(v) for k, v in b.items()})
    finally:
        jl.apply_mlp = mlp
    return tree_np, b, float(lj), gj


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
def test_step1_grads_match_jax_fp32(remat, jax_grads):
    """Every gradient leaf at 1e-4, the shared block's summed over its two uses
    by autograd as by the reference's scan (the tied unembedding's up to bf16
    flips of the loss's weight gradient, ROADMAP C13); under remat "full" and
    "dots" the groups' inner layers are checkpointed inside the group's
    checkpoint, as the reference nests them."""
    tree_np, b, lj, gj = jax_grads
    _, ct = _cfgs("float32")
    params = compat.params_from_jax(ct, tree_np, device="cpu")
    for p in tree.leaves(params):
        p.requires_grad_(True)
    lt, _ = ttrainer.make_loss_fn(ct, ttrainer.RunConfig(remat=remat))(
        params, {k: torch.from_numpy(v) for k, v in b.items()})
    assert float(lt.detach()) == pytest.approx(lj, rel=1e-5)
    gt = torch.autograd.grad(lt, tree.leaves(params))
    back = compat.params_to_jax(ct, tree.rebuild(params, list(gt)))
    assert jax.tree.structure(back) == jax.tree.structure(gj)
    assert float(np.abs(back["shared_attn"]["attn"]["wq"]["w"]).sum()) > 0
    for (path, want), got in zip(jax.tree_util.tree_leaves_with_path(gj), jax.tree.leaves(back)):
        name = jax.tree_util.keystr(path)
        if name == "['emb']['table']":
            _close_but_bf16_flips(got, np.asarray(want), name)
        else:
            np.testing.assert_allclose(got, np.asarray(want), **F32_GRADS, err_msg=name)


@pytest.mark.parametrize("arch", [ARCH, "dbrx-132b", "qwen2.5-3b"])
def test_adamw_decays_what_the_reference_decays(arch):
    """One AdamW step with weight decay from the same parameters and gradients:
    the reference decays every leaf of 2 dims or more as it stores them, so a
    Mamba2 layer's A_log, D, dt_bias and conv_b (stacked, 2 dims there) are
    decayed, and the shared block's 1-d leaves are not (ROADMAP C20)."""
    cj = jregistry.get(arch).reduced()
    ct = tregistry.get(arch).reduced()
    if arch == ARCH:
        cj, ct = _cfgs()
    tree_np = hybrid_numpy_params(cj, 11) if arch == ARCH else numpy_params(cj, 11)
    rng = np.random.default_rng(12)
    g_np = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32), tree_np)
    cfg_kw = dict(lr=1e-2, warmup_steps=1, weight_decay=0.1)
    pj = jax.tree.map(jnp.asarray, tree_np)
    new_j, _, _ = jax.jit(partial(jopt.apply_updates, jopt.OptConfig(**cfg_kw)))(
        pj, jax.tree.map(jnp.asarray, g_np), jopt.init(pj))
    pt = compat.params_from_jax(ct, tree_np, device="cpu")
    new_t, _, _ = topt.apply_updates(topt.OptConfig(**cfg_kw), pt,
                                     compat.params_from_jax(ct, g_np, device="cpu"),
                                     topt.init(pt))
    back = compat.params_to_jax(ct, new_t)
    for (path, want), got in zip(jax.tree_util.tree_leaves_with_path(new_j),
                                 jax.tree.leaves(back)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6, atol=1e-7,
                                   err_msg=jax.tree_util.keystr(path))
    if arch == ARCH:
        decayed = {path for path, p in tree.leaves_with_paths(pt)
                   if topt._decay_mask(path) and topt.reference_ndim(path, p) >= 2}
        assert ("prologue", 0, "mamba", "A_log") in decayed
        assert ("groups", 1, 0, "mamba", "dt_bias") in decayed
        assert ("shared_attn", "attn_norm", "scale") not in decayed


def test_train_step_runs_for_the_hybrid():
    """make_train_step end to end at the default remat: three steps, finite and
    falling loss."""
    from repro_torch.data.synthetic import token_batch as tbatch
    _, ct = _cfgs("bfloat16")
    run = ttrainer.RunConfig(opt=topt.OptConfig(lr=3e-3, warmup_steps=1, total_steps=10))
    state = ttrainer.init_state(ct, run, 0, device="cpu")
    step = ttrainer.make_train_step(ct, run)
    batch = {k: torch.from_numpy(v) for k, v in tbatch(ct, batch=4, seq=16, step=0).items()}
    losses = []
    for _ in range(3):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
