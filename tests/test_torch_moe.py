"""The port's MoE family (``models/moe.py``) and VLM prefix against the JAX
package's: the MoE block with both dispatches, the model's prefill, cache and
decode for the moe and vlm configs, decode against the full forward, and the
trainer's step-1 gradients with the load-balance loss.

Weights and inputs are made by numpy from a seed and handed to both sides
(``repro_torch.compat``). Routing is computed in fp32 on both sides from the
same fp32 router and inputs, so the chosen experts must be equal, index for
index (random fp32 logits have no ties).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.data.synthetic import token_batch
from repro.models import api as japi
from repro.models import moe as jmoe
from repro.train import trainer as jtrainer
from repro_torch import compat, tree
from repro_torch.configs import registry as tregistry
from repro_torch.models import api as tapi
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttransformer
from repro_torch.train import trainer as ttrainer

from test_torch_models import (BF16, F32, numpy_params, record_routes,  # noqa: F401
                               reference_mlp_follows_compute_dtype)

MOE_ARCHS = ["dbrx-132b", "grok-1-314b"]          # swiglu, untied; geglu, tied
# the MoE block alone: fp32 leaves the order of summation; bf16 rounds each
# expert product's output, at other places in the two frameworks
MOE_TOL = {"float32": dict(atol=1e-5, rtol=1e-5), "bfloat16": dict(atol=2e-2, rtol=2e-2)}
F32_GRADS = dict(rtol=1e-4, atol=1e-5)            # as tests/test_torch_train.py


def _close_but_bf16_flips(got, want, name):
    """The unembedding's weight gradient is rounded to bf16 on both sides (the
    loss's matmul, ROADMAP C13): where its fp32 value straddles a rounding
    boundary the two sides sit one bf16 ulp apart. A few elements (at most one
    in a thousand) may do so, by no more than one ulp (2**-7) of the leaf's
    largest value; every other element is held to ``F32_GRADS``."""
    err = np.abs(got - want)
    far = err > F32_GRADS["atol"] + F32_GRADS["rtol"] * np.abs(want)
    assert far.sum() <= err.size // 1000, (name, int(far.sum()))
    assert float(err.max()) <= 2 ** -7 * float(np.abs(want).max()), (name, float(err.max()))


def _cfgs(arch, dtype="float32", **kw):
    cj = dataclasses.replace(jregistry.get(arch).reduced(), compute_dtype=dtype, **kw)
    ct = dataclasses.replace(tregistry.get(arch).reduced(), compute_dtype=dtype, **kw)
    return cj, ct


def _moe_params(cj, ct, seed):
    """Layer 0's MoE leaves on both sides, from one numpy tree."""
    tree_np = numpy_params(cj, seed)
    pj = jax.tree.map(lambda a: jnp.asarray(a[0]), tree_np["blocks"]["moe"])
    pt = compat.params_from_jax(ct, tree_np, device="cpu")["blocks"][0]["moe"]
    return pj, pt


def _dropped(idx, E, group, cap):
    """(token, choice) pairs whose expert queue was full, per group of ``group`` tokens."""
    pos = torch.cumsum(torch.nn.functional.one_hot(idx.reshape(-1, group * idx.shape[-1]), E),
                       dim=1) - 1
    taken = pos.gather(2, idx.reshape(-1, group * idx.shape[-1], 1))
    return int((taken >= cap).sum())


# ---------------------------------------------------------------------------
# the MoE block
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("capacity_factor", [1.25, 8.0])
@pytest.mark.parametrize("impl", ["einsum", "scatter"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_apply_matches_jax(arch, capacity_factor, impl, dtype):
    """Two groups of 16 tokens for the einsum dispatch; at capacity 1.25 the
    einsum dispatch drops tokens, at 8.0 no dispatch does."""
    cj, ct = _cfgs(arch, dtype, capacity_factor=capacity_factor)
    pj, pt = _moe_params(cj, ct, seed=10)
    x = np.random.default_rng(11).standard_normal((2, 16, ct.d_model)).astype(np.float32)
    xj, xt = jnp.asarray(x).astype(dtype), torch.from_numpy(x).to(getattr(torch, dtype))
    yj, aj = jmoe.moe_apply(pj, xj, cj, impl=impl, group_size=16)
    yt, at = tmoe.moe_apply(pt, xt, ct, impl=impl, group_size=16)

    _, ij, _ = jmoe._route(pj, xj.reshape(-1, ct.d_model), cj)
    _, it, _ = tmoe._route(pt, xt.reshape(-1, ct.d_model), ct)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    E, k = ct.num_experts, ct.experts_per_token
    dropped = _dropped(it, E, 16, max(1, int(16 * k / E * capacity_factor)))
    assert (dropped > 0) == (capacity_factor == 1.25)

    assert yt.dtype == xt.dtype and yt.shape == xt.shape
    np.testing.assert_allclose(yt.float().numpy(), np.asarray(yj, np.float32),
                               **MOE_TOL[dtype])
    np.testing.assert_allclose(float(at), float(aj), **MOE_TOL[dtype])


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_einsum_and_scatter_agree_at_ample_capacity(arch, dtype):
    """The reference's test_moe_einsum_vs_scatter_equivalence, on the port."""
    _, ct = _cfgs(arch, dtype, capacity_factor=4.0)
    gen = torch.Generator().manual_seed(0)
    p = tmoe.moe_init(gen, ct)
    x = torch.randn((2, 16, ct.d_model), generator=gen).to(getattr(torch, dtype))
    y1, a1 = tmoe.moe_apply(p, x, ct, impl="einsum", group_size=32)
    y2, a2 = tmoe.moe_apply(p, x, ct, impl="scatter")
    assert float(a1) == float(a2)
    np.testing.assert_allclose(y1.float().numpy(), y2.float().numpy(), **MOE_TOL[dtype])


def test_einsum_dispatch_refuses_tokens_that_do_not_group():
    """26 tokens in groups of 8: the reference fails inside its reshape, the
    port raises a ValueError that names both numbers."""
    cj, ct = _cfgs("dbrx-132b")
    pj, pt = _moe_params(cj, ct, seed=12)
    with pytest.raises(TypeError):
        jmoe.moe_apply(pj, jnp.zeros((2, 13, ct.d_model)), cj, group_size=8)
    with pytest.raises(ValueError, match="26 tokens.*groups of 8"):
        tmoe.moe_apply(pt, torch.zeros((2, 13, ct.d_model)), ct, group_size=8)
    with pytest.raises(ValueError, match="unknown moe impl"):
        tmoe.moe_apply(pt, torch.zeros((1, 4, ct.d_model)), ct, impl="sort")
    # fewer tokens than a group form one group
    y, _ = tmoe.moe_apply(pt, torch.zeros((2, 13, ct.d_model)), ct)
    assert y.shape == (2, 13, ct.d_model)


def test_aux_loss_matches_jax_and_is_e_times_uniform_when_balanced():
    rng = np.random.default_rng(13)
    probs = rng.random((24, 4)).astype(np.float32)
    probs /= probs.sum(-1, keepdims=True)
    idx = rng.integers(0, 4, (24, 2))
    want = float(jmoe.aux_load_balance_loss(jnp.asarray(probs), jnp.asarray(idx), 4))
    got = float(tmoe.aux_load_balance_loss(torch.from_numpy(probs), torch.from_numpy(idx), 4))
    assert got == pytest.approx(want, rel=1e-6)
    flat = torch.full((8, 4), 0.25)
    even = torch.arange(16).reshape(8, 2) % 4
    assert float(tmoe.aux_load_balance_loss(flat, even, 4)) == pytest.approx(1.0)


# ---------------------------------------------------------------------------
# the model: forward, prefill, cache and decode
# ---------------------------------------------------------------------------

def _batches(cfg, toks, seed):
    """The same batch for both sides; a vlm batch carries a prefix of
    ``frontend_len`` embeddings."""
    bj, bt = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
    if cfg.family == "vlm":
        e = 0.1 * np.random.default_rng(seed).standard_normal(
            (toks.shape[0], cfg.frontend_len, cfg.d_model)).astype(np.float32)
        bj["embeds"], bt["embeds"] = jnp.asarray(e), torch.from_numpy(e)
    return bj, bt


def _close(t, j, tol):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32), **tol)


def _model_parity(arch, dtype, tol, moe_impl):
    cj, ct = _cfgs(arch, dtype)
    tree_np = numpy_params(cj, 14)
    pj = jax.tree.map(jnp.asarray, tree_np)
    pt = compat.params_from_jax(ct, tree_np, device="cpu")
    rng = np.random.default_rng(15)
    B, S, S_max = 2, 13, 32
    P = ct.frontend_len
    toks = rng.integers(0, ct.vocab_size, (B, S + 1))
    bj, bt = _batches(ct, toks[:, :S], 16)

    hj, auxj = japi.forward_hidden(cj, pj, bj, remat="none", moe_impl=moe_impl)
    with torch.no_grad():
        ht, auxt = tapi.forward_hidden(ct, pt, bt, remat="none", moe_impl=moe_impl)
    assert ht.shape == (B, P + S, ct.d_model)
    _close(ht, hj, tol)
    if ct.family == "moe":
        assert float(auxt) == pytest.approx(float(auxj), rel=tol["rtol"])
    else:
        assert auxt == auxj == 0.0

    # the reference's prefill and decode take the einsum dispatch; the port's
    # transformer takes moe_impl too: in one group of T <= 512 tokens the
    # scatter dispatch keeps and drops the same choices as the einsum one
    hj, cache_j = japi.prefill(cj, pj, bj, max_seq=S_max, remat="none")
    with torch.no_grad():
        ht, cache_t = ttransformer.prefill_lm(ct, pt, bt["tokens"], embeds=bt.get("embeds"),
                                              max_seq=S_max, moe_impl=moe_impl)
    assert cache_t["idx"] == P + S == int(cache_j["idx"])
    _close(ht, hj, tol)
    _close(cache_t["k"], cache_j["k"], tol)
    _close(cache_t["v"], cache_j["v"], tol)
    _close(tapi.unembed(ct, pt, ht[:, -1:]), japi.unembed(cj, pj, hj[:, -1:]), tol)

    lj, cache_j2 = japi.decode(cj, pj, cache_j, jnp.asarray(toks[:, S:]))
    with torch.no_grad():
        lt, _ = ttransformer.decode_lm(ct, pt, cache_t, torch.from_numpy(toks[:, S:]),
                                       moe_impl=moe_impl)
    assert lt.shape == (B, 1, ct.vocab_size) and cache_t["idx"] == P + S + 1
    _close(lt, lj, tol)
    _close(cache_t["k"], cache_j2["k"], tol)


@pytest.mark.parametrize("arch,moe_impl", [("dbrx-132b", "einsum"), ("dbrx-132b", "scatter"),
                                           ("grok-1-314b", "einsum"),
                                           ("grok-1-314b", "scatter"),
                                           ("pixtral-12b", "einsum")])
def test_forward_prefill_cache_and_decode_match_jax_fp32(arch, moe_impl,
                                                         reference_mlp_follows_compute_dtype):
    _model_parity(arch, "float32", F32, moe_impl)


@pytest.mark.parametrize("arch", MOE_ARCHS + ["pixtral-12b"])
def test_forward_prefill_cache_and_decode_match_jax_bf16(arch):
    _model_parity(arch, "bfloat16", BF16, "einsum")


@pytest.mark.parametrize("arch", MOE_ARCHS + ["pixtral-12b"])
def test_decode_matches_full_forward(arch):
    """As the JAX package's test of the same name: bf16 compute; a moe config at
    capacity 8, where one-token decode drops no more than the batched forward."""
    ct = tregistry.get(arch).reduced()
    if ct.family == "moe":
        ct = dataclasses.replace(ct, capacity_factor=8.0)
    pt = tapi.init(ct, 0, device="cpu")
    B, S = 2, 13
    toks = np.random.default_rng(17).integers(0, ct.vocab_size, (B, S + 1))
    _, full = _batches(ct, toks, 18)
    _, pre = _batches(ct, toks[:, :S], 18)
    with torch.no_grad():
        hidden, _ = tapi.forward_hidden(ct, pt, full, remat="none")
        logits_full = tapi.unembed(ct, pt, hidden[:, -1:])
        _, cache = tapi.prefill(ct, pt, pre, max_seq=S + ct.frontend_len + 8)
        logits_dec, _ = tapi.decode(ct, pt, cache, torch.from_numpy(toks[:, S:S + 1]))
    np.testing.assert_allclose(logits_dec.float().numpy(), logits_full.float().numpy(),
                               atol=2e-2, rtol=2e-2)


def test_decode_drops_choices_at_the_default_capacity(monkeypatch):
    """Four slots decode as one group of 4 tokens: capacity max(1, int(4*k/E*1.25))
    is 1 for dbrx's 16 experts top-4, and the choices past it are dropped, as in
    the reference (the engine's decode runs at the config's capacity factor)."""
    cfg = tregistry.get("dbrx-132b")
    E, k = cfg.num_experts, cfg.experts_per_token
    assert max(1, int(4 * k / E * cfg.capacity_factor)) == 1
    ct = dataclasses.replace(cfg.reduced(), num_experts=E, experts_per_token=k)
    pt = tapi.init(ct, 0, device="cpu")
    seen = record_routes(monkeypatch)
    cache = tapi.init_cache(ct, 4, 8, device="cpu")
    with torch.no_grad():
        tapi.decode(ct, pt, cache, torch.arange(4).reshape(4, 1))
    assert len(seen) == ct.num_layers
    for _, idx in seen:
        assert idx.shape == (4, k)
        distinct = len(set(idx.reshape(-1).tolist()))
        assert _dropped(idx, E, 4, 1) == 4 * k - distinct > 0


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,moe_impl", [("dbrx-132b", "einsum"), ("dbrx-132b", "scatter"),
                                           ("grok-1-314b", "einsum"),
                                           ("grok-1-314b", "scatter"),
                                           ("pixtral-12b", "einsum")])
def test_step1_grads_match_jax_fp32(arch, moe_impl, reference_mlp_follows_compute_dtype):
    """The loss with 0.01 x the load-balance loss: its value, aux, and every
    gradient leaf, the router's included (the unembedding's up to bf16 flips)."""
    cj, ct = _cfgs(arch)
    tree_np = numpy_params(cj, 19)
    b = token_batch(cj, batch=4, seq=16, step=0)
    bj = {k: jnp.asarray(v) for k, v in b.items()}
    bt = {k: torch.from_numpy(v) for k, v in b.items()}
    run_kw = dict(remat="none", moe_impl=moe_impl, moe_aux_weight=0.01)
    (lj, mj), gj = jax.value_and_grad(jtrainer.make_loss_fn(cj, jtrainer.RunConfig(**run_kw)),
                                      has_aux=True)(jax.tree.map(jnp.asarray, tree_np), bj)
    params = compat.params_from_jax(ct, tree_np, device="cpu")
    for p in tree.leaves(params):
        p.requires_grad_(True)
    lt, mt = ttrainer.make_loss_fn(ct, ttrainer.RunConfig(**run_kw))(params, bt)
    aux = float(mt["aux"].detach())
    if ct.family == "moe":
        assert aux > 0
        assert float(lt.detach()) == pytest.approx(float(mt["loss"].detach()) + 0.01 * aux,
                                                   rel=1e-6)
    assert float(lt.detach()) == pytest.approx(float(lj), rel=1e-5)
    assert aux == pytest.approx(float(mj["aux"]), rel=1e-5)
    unembed = "['emb']['table']" if ct.tie_embeddings else "['unembed']['w']"
    gt = torch.autograd.grad(lt, tree.leaves(params))
    back = compat.params_to_jax(ct, tree.rebuild(params, list(gt)))
    assert jax.tree.structure(back) == jax.tree.structure(gj)
    for (path, want), got in zip(jax.tree_util.tree_leaves_with_path(gj), jax.tree.leaves(back)):
        name = jax.tree_util.keystr(path)
        if name == unembed:
            _close_but_bf16_flips(got, np.asarray(want), name)
        else:
            np.testing.assert_allclose(got, np.asarray(want), **F32_GRADS, err_msg=name)


def test_trainer_cast_params_casts_the_router_as_the_reference(monkeypatch):
    """``RunConfig.cast_params="bfloat16"`` casts every floating leaf, the router
    too, as the reference's loss does; serving's ``cast_params`` keeps it fp32.
    Step-1 loss against the JAX loss under the same cast."""
    cj, ct = _cfgs("dbrx-132b", "bfloat16")
    tree_np = numpy_params(cj, 20)
    b = token_batch(cj, batch=4, seq=16, step=0)
    run_kw = dict(cast_params="bfloat16", remat="none")
    lj, _ = jtrainer.make_loss_fn(cj, jtrainer.RunConfig(**run_kw))(
        jax.tree.map(jnp.asarray, tree_np), {k: jnp.asarray(v) for k, v in b.items()})
    seen = record_routes(monkeypatch)
    params = compat.params_from_jax(ct, tree_np, device="cpu")
    lt, _ = ttrainer.make_loss_fn(ct, ttrainer.RunConfig(**run_kw))(
        params, {k: torch.from_numpy(v) for k, v in b.items()})
    assert [dt for dt, _ in seen] == [torch.bfloat16] * ct.num_layers
    assert float(lt) == pytest.approx(float(lj), rel=2e-2)
    seen.clear()
    with torch.no_grad():
        tapi.forward_hidden(ct, tapi.cast_params(ct, params), {"tokens": torch.from_numpy(
            b["tokens"])}, remat="none")
    assert [dt for dt, _ in seen] == [torch.float32] * ct.num_layers


def test_train_step_runs_for_moe_and_vlm():
    """make_train_step end to end: three steps of each family, finite and
    falling loss; the moe aux metric is reported."""
    from repro_torch.data.synthetic import token_batch as tbatch
    from repro_torch.train import optimizer as topt
    for arch in ("dbrx-132b", "pixtral-12b"):
        ct = tregistry.get(arch).reduced()
        run = ttrainer.RunConfig(opt=topt.OptConfig(lr=3e-3, warmup_steps=1, total_steps=10))
        state = ttrainer.init_state(ct, run, 0, device="cpu")
        step = ttrainer.make_train_step(ct, run)
        batch = {k: torch.from_numpy(v) for k, v in tbatch(ct, batch=4, seq=16, step=0).items()}
        losses = []
        for _ in range(3):
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
            assert (float(m["aux"]) > 0) == (ct.family == "moe")
        assert all(np.isfinite(losses)) and losses[-1] < losses[0], (arch, losses)
