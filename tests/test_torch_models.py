"""Port vs JAX package through ``models.api``: prefill hidden states, the decode
cache and decode logits, for reduced dense configs.

Weights and tokens are made by numpy from a seed and handed to both sides
(``repro_torch.compat``). On the CPU the port's attention goes through the plain
versions of its kernels; the JAX side goes through ``flash_ref`` /
``decode_attend``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models import api as japi
from repro_torch import compat
from repro_torch.configs import registry as tregistry
from repro_torch.models import api as tapi

ARCHS = ["qwen2.5-3b", "olmo-1b", "llama3-8b"]
# fp32 compute, every product and sum fp32 on both sides: what is left is the
# order of summation and the last bits of exp / rsqrt / sin / cos, through two
# layers, on O(1) values.
F32 = dict(atol=1e-4, rtol=1e-4)
# bf16 compute: every matmul output is rounded to bf16, at other places in the
# two frameworks, through 2 layers; logits are O(1).
BF16 = dict(atol=5e-2, rtol=5e-2)


@pytest.fixture
def reference_mlp_follows_compute_dtype(monkeypatch):
    """The reference's block calls ``apply_mlp`` without a dtype, so its MLP runs
    in bf16 even when ``cfg.compute_dtype`` is float32; the port's follows the
    config (a deliberate deviation, see CHANGES.md). For the fp32 comparisons the
    reference's default is set to float32 here, for the length of one test, so
    that the two sides compute the same function and can be held to 1e-4. No file
    of the JAX package changes; the bf16 cases run the reference as it is."""
    from functools import partial
    from repro.models import layers as jl
    monkeypatch.setattr(jl, "apply_mlp", partial(jl.apply_mlp, dtype=jnp.float32))


def numpy_params(cfg_j, seed):
    """The JAX tree's structure and shapes, filled by numpy from a seed."""
    shapes = jax.eval_shape(lambda: japi.init(cfg_j, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(seed)

    def fill(path, s):
        name = jax.tree_util.keystr(path)
        if "norm" in name and "scale" in name:
            return (1.0 + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        if name.endswith("['b']") or "bias" in name:
            return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        fan_in = s.shape[-2] if "table" not in name else s.shape[-1]
        return (rng.standard_normal(s.shape) / np.sqrt(fan_in)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def both(arch, dtype, seed=0):
    cj = dataclasses.replace(jregistry.get(arch).reduced(), compute_dtype=dtype)
    ct = dataclasses.replace(tregistry.get(arch).reduced(), compute_dtype=dtype)
    tree = numpy_params(cj, seed)
    pj = jax.tree.map(jnp.asarray, tree)
    pt = compat.params_from_jax(ct, tree, device="cpu")
    return cj, ct, pj, pt


def _close(t, j, tol):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32), **tol)


def _prefill_decode_parity(arch, dtype, tol):
    cj, ct, pj, pt = both(arch, dtype)
    rng = np.random.default_rng(1)
    B, S, S_max = 2, 13, 24
    toks = rng.integers(0, ct.vocab_size, (B, S + 1))

    hj, cache_j = japi.prefill(cj, pj, {"tokens": jnp.asarray(toks[:, :S])}, max_seq=S_max,
                               remat="none")
    with torch.no_grad():
        ht, cache_t = tapi.prefill(ct, pt, {"tokens": torch.from_numpy(toks[:, :S])},
                                   max_seq=S_max)
    assert ht.shape == (B, S, ct.d_model)
    assert cache_t["k"].shape == (ct.num_layers, B, S_max, ct.num_kv_heads, ct.head_dim)
    assert cache_t["idx"] == S == int(cache_j["idx"])
    _close(ht, hj, tol)
    _close(cache_t["k"], cache_j["k"], tol)
    _close(cache_t["v"], cache_j["v"], tol)

    lj, cache_j2 = japi.decode(cj, pj, cache_j, jnp.asarray(toks[:, S:]))
    with torch.no_grad():
        lt, cache_t2 = tapi.decode(ct, pt, cache_t, torch.from_numpy(toks[:, S:]))
    assert cache_t2 is cache_t and cache_t["idx"] == S + 1     # updated in place
    assert lt.shape == (B, 1, ct.vocab_size)
    _close(lt, lj, tol)
    _close(cache_t["k"], cache_j2["k"], tol)
    _close(tapi.unembed(ct, pt, ht[:, -1:]), japi.unembed(cj, pj, hj[:, -1:]), tol)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_cache_and_decode_match_jax_fp32(arch, reference_mlp_follows_compute_dtype):
    _prefill_decode_parity(arch, "float32", F32)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_cache_and_decode_match_jax_bf16(arch):
    _prefill_decode_parity(arch, "bfloat16", BF16)


def test_fp32_config_against_the_reference_as_it_is():
    """Without the fixture the reference's MLP is bf16 and the port's fp32: they
    differ by the MLP's bf16 rounding and no more."""
    _prefill_decode_parity("qwen2.5-3b", "float32", BF16)


@pytest.mark.parametrize("arch", ARCHS)
def test_cast_params_gives_the_same_numbers(arch):
    _, ct, _, pt = both(arch, "bfloat16", seed=2)
    cast = tapi.cast_params(ct, pt)
    blk = cast["blocks"][0]
    assert blk["attn"]["wq"]["w"].dtype == torch.bfloat16
    assert blk["mlp"]["wd"]["w"].dtype == torch.bfloat16
    assert cast["emb"]["table"].dtype == torch.bfloat16
    if "scale" in cast["final_norm"]:
        assert cast["final_norm"]["scale"].dtype == torch.float32
        assert blk["attn_norm"]["scale"].dtype == torch.float32
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, ct.vocab_size, (1, 9)))
    with torch.no_grad():
        h1, c1 = tapi.prefill(ct, pt, {"tokens": toks}, max_seq=12)
        h2, c2 = tapi.prefill(ct, cast, {"tokens": toks}, max_seq=12)
        l1, _ = tapi.decode(ct, pt, c1, toks[:, -1:])
        l2, _ = tapi.decode(ct, cast, c2, toks[:, -1:])
    assert torch.equal(h1, h2) and torch.equal(l1, l2)
    c32 = dataclasses.replace(ct, compute_dtype="float32")
    cast32 = tapi.cast_params(c32, pt)
    assert cast32["blocks"][0]["attn"]["wq"]["w"] is pt["blocks"][0]["attn"]["wq"]["w"]
    assert cast32["blocks"][0]["mlp"]["wg"]["w"].dtype == torch.float32


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_full_forward(arch):
    ct = tregistry.get(arch).reduced()
    pt = tapi.init(ct, 0, device="cpu")
    rng = np.random.default_rng(4)
    B, S = 2, 13
    toks = torch.from_numpy(rng.integers(0, ct.vocab_size, (B, S + 1)))
    with torch.no_grad():
        hidden, _ = tapi.forward_hidden(ct, pt, {"tokens": toks}, remat="none")
        logits_full = tapi.unembed(ct, pt, hidden[:, -1:])
        _, cache = tapi.prefill(ct, pt, {"tokens": toks[:, :S]}, max_seq=S + 8)
        logits_dec, _ = tapi.decode(ct, pt, cache, toks[:, S:S + 1])
    # as the JAX package's own test of the same name: bf16 compute
    np.testing.assert_allclose(logits_dec.float().numpy(), logits_full.float().numpy(),
                               atol=2e-2, rtol=2e-2)


def test_prefill_through_explicit_attn_fn_and_reference_mode_agree():
    from repro_torch.models.attention import flash_ref
    _, ct, _, pt = both("qwen2.5-3b", "float32", seed=5)
    toks = torch.from_numpy(np.random.default_rng(6).integers(0, ct.vocab_size, (2, 11)))
    with torch.no_grad():
        h0, _ = tapi.prefill(ct, pt, {"tokens": toks})
        h1, _ = tapi.prefill(ct, pt, {"tokens": toks}, mode="reference")
        h2, _ = tapi.prefill(ct, pt, {"tokens": toks},
                             attn_fn=lambda q, k, v, causal: flash_ref(q, k, v, causal=causal,
                                                                       chunk=4))
    assert torch.equal(h0, h1)
    np.testing.assert_allclose(h2.numpy(), h0.numpy(), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("arch,family", [
    ("dbrx-132b", "moe"), ("zamba2-7b", "hybrid"), ("rwkv6-7b", "ssm"),
    ("pixtral-12b", "vlm"), ("whisper-large-v3", "encdec")])
def test_unported_family_raises(arch, family):
    cfg = tregistry.get(arch).reduced()
    assert cfg.family == family
    with pytest.raises(NotImplementedError, match=family):
        tapi.init(cfg, 0, device="cpu")
    with pytest.raises(NotImplementedError, match=family):
        tapi.init_cache(cfg, 1, 8, device="cpu")


def test_seeded_init_is_reproducible_and_shaped_like_jax():
    cj = jregistry.get("qwen2.5-3b").reduced()
    ct = tregistry.get("qwen2.5-3b").reduced()
    p1, p2 = tapi.init(ct, 7, device="cpu"), tapi.init(ct, 7, device="cpu")
    p3 = tapi.init(ct, 8, device="cpu")
    w = lambda p: p["blocks"][1]["attn"]["wk"]["w"]
    assert torch.equal(w(p1), w(p2)) and not torch.equal(w(p1), w(p3))
    shapes = jax.eval_shape(lambda: japi.init(cj, jax.random.PRNGKey(0)))
    back = compat.params_to_jax(ct, p1)
    assert (jax.tree.structure(back) == jax.tree.structure(shapes))
    for a, s in zip(jax.tree.leaves(back), jax.tree.leaves(shapes)):
        assert a.shape == s.shape and a.dtype == np.float32
