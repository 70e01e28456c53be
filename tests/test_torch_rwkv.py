"""The port's RWKV6 block (``models/rwkv.py``) and ssm family (rwkv6-7b)
against the JAX package's: ``time_mix`` on its one-token and chunked paths,
the chunked-against-recurrent self-check, ``channel_mix``, the model's forward,
prefill cache and decode, the step-1 gradients, the optimizer's decay rule,
``cast_params`` and the parameter hand-over. (The engine's greedy tokens are
held to the JAX engine's in ``test_torch_serve.py``.)

Weights and inputs are made by numpy from a seed in the JAX layout and handed
to both sides (``repro_torch.compat``); the decay base is drawn from [-6, 1], so
per-step decays run from about 0.998 to 0.07, and the norms' scales lie near 1.
The gradient tests draw it from [-6, -1] (GRAD_DECAY_HI): where a chunk's
cumulative log-decay spans more than ~88, exp overflows above the diagonal,
the where drops it from the forward, and autograd of the where multiplies
that inf by 0. Both sides then give NaN gradients (mirrored, ROADMAP C23).
The model runs at reduced width (2 layers, d_model 64, 4 heads of 16).
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
from repro.models import rwkv as jrwkv
from repro.train import optimizer as jopt
from repro.train import trainer as jtrainer
from repro_torch import compat, tree
from repro_torch.configs import registry as tregistry
from repro_torch.models import api as tapi
from repro_torch.models import rwkv as trwkv
from repro_torch.models import transformer as ttransformer
from repro_torch.train import optimizer as topt
from repro_torch.train import trainer as ttrainer

from test_torch_models import F32, numpy_params
from test_torch_moe import F32_GRADS, _close_but_bf16_flips

ARCH = "rwkv6-7b"
GRAD_DECAY_HI = -1.0
# the block alone: fp32 leaves the order of summation (the chunk's products are
# contracted in other orders); bf16 rounds only the block's input and output
BLOCK_TOL = {"float32": dict(atol=2e-5, rtol=2e-5), "bfloat16": dict(atol=2e-2, rtol=2e-2)}
# the model in fp32 as every fp32 model comparison of the port
# (test_torch_models.F32): through two layers and 70 tokens the states are
# summed in other orders. In bf16, relative to each tensor's norm: the states
# sum k v^T over the prompt, so a bf16 flip of a layer's input moves an O(50)
# element by O(0.5), and 70 tokens on, the port's bf16 hidden states and decode
# logits read 0.008 and 0.021 from the reference's (elementwise up to 0.1), where
# the reference's own bf16 run reads 0.014 and 0.036 from its fp32 run
BF16_REL = 5e-2


def _cfgs(dtype="float32"):
    cj = dataclasses.replace(jregistry.get(ARCH).reduced(), compute_dtype=dtype)
    ct = dataclasses.replace(tregistry.get(ARCH).reduced(), compute_dtype=dtype)
    return cj, ct


def rwkv_numpy_params(cj, seed, decay_hi=1.0):
    """``test_torch_models.numpy_params`` (norm scales near 1) with the decay
    base drawn from [-6, ``decay_hi``]."""
    tree_np = numpy_params(cj, seed)
    tmix = tree_np["blocks"]["block"]["tmix"]
    tmix["decay"] = np.random.default_rng(seed + 1000).uniform(
        -6.0, decay_hi, tmix["decay"].shape).astype(np.float32)
    return tree_np


def _both_params(cj, ct, seed):
    tree_np = rwkv_numpy_params(cj, seed)
    return tree_np, jax.tree.map(jnp.asarray, tree_np), compat.params_from_jax(
        ct, tree_np, device="cpu")


def _close(t, j, tol, what=""):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32), **tol,
                               err_msg=what)


def _layer0(pj, pt, part):
    return jax.tree.map(lambda a: a[0], pj["blocks"]["block"][part]), pt["blocks"][0]["block"][part]


def _state(ct, B, rng, zero=False):
    st = trwkv.rwkv_state_init(ct, B, device="cpu")
    if zero:
        return {k: v.numpy() for k, v in st.items()}
    return {k: (0.5 * rng.standard_normal(v.shape)).astype(np.float32) for k, v in st.items()}


# ---------------------------------------------------------------------------
# the block
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("path,S,chunk", [
    ("one_token", 1, 64),
    ("one_chunk", 12, 64),
    ("chunks_last_padded", 20, 8),       # three chunks of 8, the last holding 4 rows
    ("chunks_from_a_state", 16, 8),
])
def test_time_mix_matches_jax(dtype, path, S, chunk):
    """Output, final state and the last token, from a zero state or a random one."""
    cj, ct = _cfgs(dtype)
    _, pj, pt = _both_params(cj, ct, 0)
    pj, pt = _layer0(pj, pt, "tmix")
    rng = np.random.default_rng(1)
    B = 2
    x = rng.standard_normal((B, S, ct.d_model)).astype(np.float32)
    st = _state(ct, B, rng, zero=path in ("one_chunk", "chunks_last_padded"))
    yj, Sj, xj = jrwkv.time_mix(pj, jnp.asarray(x).astype(dtype), cj, S0=jnp.asarray(st["S"]),
                                x_prev=jnp.asarray(st["x_att"]), chunk=chunk)
    yt, St, xt = trwkv.time_mix(pt, torch.from_numpy(x).to(getattr(torch, dtype)), ct,
                                S0=torch.from_numpy(st["S"]),
                                x_prev=torch.from_numpy(st["x_att"]), chunk=chunk)
    assert yt.dtype == getattr(torch, dtype) and yt.shape == (B, S, ct.d_model)
    assert St.dtype == xt.dtype == torch.float32
    _close(yt, yj, BLOCK_TOL[dtype], "y")
    _close(St, Sj, BLOCK_TOL["float32"], "state")
    _close(xt, xj, BLOCK_TOL["float32"], "last token")


@pytest.mark.parametrize("chunk", [4, 64])
def test_rwkv_chunked_matches_recurrent(chunk):
    """The reference's own check on the port, at its tolerances: 9 tokens as one
    chunked call (chunks of 4, the last padded; or one chunk) and as 9
    one-token calls carried through the state."""
    ct = tregistry.get(ARCH).reduced()
    p = trwkv.rwkv_init(torch.Generator().manual_seed(0), ct)["tmix"]
    B, S, d = 2, 9, ct.d_model
    x = 0.5 * torch.randn((B, S, d), generator=torch.Generator().manual_seed(1))
    S0 = torch.zeros((B, d // ct.rwkv_head_dim, ct.rwkv_head_dim, ct.rwkv_head_dim))
    x_prev = torch.zeros((B, d))
    y_chunk, S_chunk, _ = trwkv.time_mix(p, x, ct, S0=S0, x_prev=x_prev, chunk=chunk)
    Sr, xp, ys = S0, x_prev, []
    for t in range(S):
        y_t, Sr, xp = trwkv.time_mix(p, x[:, t:t + 1], ct, S0=Sr, x_prev=xp)
        ys.append(y_t)
    np.testing.assert_allclose(torch.cat(ys, 1).numpy(), y_chunk.numpy(), atol=2e-3, rtol=2e-3)
    np.testing.assert_allclose(Sr.numpy(), S_chunk.numpy(), atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_channel_mix_matches_jax(dtype):
    cj, ct = _cfgs(dtype)
    _, pj, pt = _both_params(cj, ct, 2)
    pj, pt = _layer0(pj, pt, "cmix")
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 7, ct.d_model)).astype(np.float32)
    xp = rng.standard_normal((2, ct.d_model)).astype(np.float32)
    yj, lj = jrwkv.channel_mix(pj, jnp.asarray(x).astype(dtype), x_prev=jnp.asarray(xp))
    yt, lt = trwkv.channel_mix(pt, torch.from_numpy(x).to(getattr(torch, dtype)),
                               x_prev=torch.from_numpy(xp))
    assert yt.dtype == getattr(torch, dtype) and lt.dtype == torch.float32
    _close(yt, yj, BLOCK_TOL[dtype], "y")
    _close(lt, lj, BLOCK_TOL["float32"], "last token")


# ---------------------------------------------------------------------------
# the model: forward, prefill cache and decode
# ---------------------------------------------------------------------------

def _restack(states):
    """A list of per-layer {"S", "x_att", "x_cmix"} as the JAX cache's stacked leaves."""
    return {k: np.stack([st[k].numpy() for st in states]) for k in states[0]}


def _held(got, want, dtype, what):
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **F32, err_msg=what)
    else:
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert rel < BF16_REL, (what, rel)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_prefill_cache_and_decode_match_jax(dtype):
    """70 prompt tokens (two chunks of 64, the second padded), then two decode
    steps: hidden states, logits and every state leaf of the cache."""
    cj, ct = _cfgs(dtype)
    _, pj, pt = _both_params(cj, ct, 4)
    rng = np.random.default_rng(5)
    B, S = 2, 70
    toks = rng.integers(0, ct.vocab_size, (B, S + 2))
    bj, bt = {"tokens": jnp.asarray(toks[:, :S])}, {"tokens": torch.from_numpy(toks[:, :S])}

    hj, auxj = japi.forward_hidden(cj, pj, bj, remat="none")
    with torch.no_grad():
        ht, auxt = tapi.forward_hidden(ct, pt, bt, remat="none")
    assert ht.shape == (B, S, ct.d_model) and auxt == auxj == 0.0
    _held(ht, hj, dtype, "forward hidden")

    hj, cache_j = japi.prefill(cj, pj, bj, max_seq=S + 8, remat="none")
    with torch.no_grad():
        ht, cache_t = tapi.prefill(ct, pt, bt, max_seq=S + 8)
    assert cache_t["idx"] == S == int(cache_j["idx"]) and len(cache_t["layers"]) == 2
    _held(ht, hj, dtype, "prefill hidden")
    _held(tapi.unembed(ct, pt, ht[:, -1:]), japi.unembed(cj, pj, hj[:, -1:]), dtype, "logits")

    def states_held(when, jcache):
        got = _restack(cache_t["layers"])
        for k in ("S", "x_att", "x_cmix"):
            assert got[k].dtype == np.float32 and got[k].shape == jcache["layers"][k].shape
            _held(torch.from_numpy(got[k]), jcache["layers"][k], dtype, f"{when} {k}")

    states_held("prefill", cache_j)
    for t in (S, S + 1):
        lj, cache_j = japi.decode(cj, pj, cache_j, jnp.asarray(toks[:, t:t + 1]))
        with torch.no_grad():
            lt, same = tapi.decode(ct, pt, cache_t, torch.from_numpy(toks[:, t:t + 1]))
        assert same is cache_t and cache_t["idx"] == t + 1          # updated in place
        assert lt.shape == (B, 1, ct.vocab_size)
        _held(lt, lj, dtype, f"decode logits at {t}")
        states_held(f"decode at {t}", cache_j)


def test_decode_matches_full_forward():
    """As the JAX package's test of the same name: bf16 compute."""
    _, ct = _cfgs("bfloat16")
    pt = tapi.init(ct, 0, device="cpu")
    B, S = 2, 13
    toks = torch.from_numpy(np.random.default_rng(6).integers(0, ct.vocab_size, (B, S + 1)))
    with torch.no_grad():
        hidden, _ = tapi.forward_hidden(ct, pt, {"tokens": toks}, remat="none")
        logits_full = tapi.unembed(ct, pt, hidden[:, -1:])
        _, cache = tapi.prefill(ct, pt, {"tokens": toks[:, :S]}, max_seq=S + 8)
        logits_dec, _ = tapi.decode(ct, pt, cache, toks[:, S:S + 1])
    np.testing.assert_allclose(logits_dec.float().numpy(), logits_full.float().numpy(),
                               atol=2e-2, rtol=2e-2)


def test_ssm_config_initialises_and_caches():
    """A seeded init shaped as the JAX package's (blocks stacked there, ln0
    beside them), and a cache of fp32 states shaped as its stacked one."""
    cj, ct = jregistry.get(ARCH).reduced(), tregistry.get(ARCH).reduced()
    params = tapi.init(ct, 0, device="cpu")
    shapes = jax.eval_shape(lambda: japi.init(cj, jax.random.PRNGKey(0)))
    back = compat.params_to_jax(ct, params)
    assert jax.tree.structure(back) == jax.tree.structure(shapes)
    for a, s in zip(jax.tree.leaves(back), jax.tree.leaves(shapes)):
        assert a.shape == s.shape and a.dtype == np.float32
    assert float(params["blocks"][1]["block"]["tmix"]["decay"][0]) == -4.0
    cache = tapi.init_cache(ct, 3, 8, device="cpu")
    jcache = jax.eval_shape(lambda: japi.init_cache(cj, 3, 8))
    got = _restack(cache["layers"])
    for k, v in got.items():
        assert v.shape == jcache["layers"][k].shape and v.dtype == np.float32
    assert cache["idx"] == 0 and set(cache) == {"layers", "idx"}


# ---------------------------------------------------------------------------
# cast_params, the hand-over, the trainer and the optimizer
# ---------------------------------------------------------------------------

def test_cast_params_keeps_the_block_and_norms_fp32(monkeypatch):
    """bf16 compute: the same hidden states and logits with and without the
    cast; every leaf of each layer's ``block`` and ln0 / ln1 / ln2 still fp32,
    emb and unembed bf16. With the rule before the ssm family was ported the
    block's weights are rounded and the numbers move, with no error: the fault
    this test is for (ROADMAP C19)."""
    cj, ct = _cfgs("bfloat16")
    _, _, pt = _both_params(cj, ct, 7)
    cast = tapi.cast_params(ct, pt)
    for blk in cast["blocks"]:
        assert all(t.dtype == torch.float32 for t in tree.leaves(blk))
    assert all(t.dtype == torch.float32 for t in tree.leaves(cast["ln0"]))
    assert cast["emb"]["table"].dtype == cast["unembed"]["w"].dtype == torch.bfloat16

    toks = torch.from_numpy(np.random.default_rng(8).integers(0, ct.vocab_size, (1, 20)))

    def run(params):
        with torch.no_grad():
            h, c = tapi.prefill(ct, params, {"tokens": toks}, max_seq=24)
            lg, _ = tapi.decode(ct, params, c, toks[:, -1:])
        return h, lg

    h1, l1 = run(pt)
    h2, l2 = run(cast)
    assert torch.equal(h1, h2) and torch.equal(l1, l2)
    monkeypatch.setattr(ttransformer, "_FP32_KEYS", tuple(
        k for k in ttransformer._FP32_KEYS if k not in ("block", "ln0", "ln1", "ln2")))
    h3, _ = run(tapi.cast_params(ct, pt))
    assert not torch.equal(h1, h3)


def test_compat_round_trip():
    """blocks stacked on one dim there, a list here; ln0 crosses as it is."""
    cj, ct = _cfgs()
    tree_np = rwkv_numpy_params(cj, 9)
    pt = compat.params_from_jax(ct, tree_np, device="cpu")
    assert len(pt["blocks"]) == ct.num_layers
    np.testing.assert_array_equal(pt["blocks"][1]["block"]["tmix"]["maa_w2"].numpy(),
                                  tree_np["blocks"]["block"]["tmix"]["maa_w2"][1])
    np.testing.assert_array_equal(pt["blocks"][0]["ln2"]["bias"].numpy(),
                                  tree_np["blocks"]["ln2"]["bias"][0])
    np.testing.assert_array_equal(pt["ln0"]["scale"].numpy(), tree_np["ln0"]["scale"])
    back = compat.params_to_jax(ct, pt)
    assert jax.tree.structure(back) == jax.tree.structure(tree_np)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree_np)):
        np.testing.assert_array_equal(a, b)


def _jax_step1(dtype, seed):
    cj, _ = _cfgs(dtype)
    tree_np = rwkv_numpy_params(cj, seed, GRAD_DECAY_HI)
    b = token_batch(cj, batch=2, seq=20, step=0)
    (lj, _), gj = jax.value_and_grad(
        jtrainer.make_loss_fn(cj, jtrainer.RunConfig(remat="none")), has_aux=True)(
            jax.tree.map(jnp.asarray, tree_np), {k: jnp.asarray(v) for k, v in b.items()})
    return tree_np, b, float(lj), gj


@pytest.fixture(scope="module")
def jax_grads():
    """Step-1 loss and gradients of the JAX package at fp32."""
    return _jax_step1("float32", 10)


def _port_step1(dtype, tree_np, b, remat):
    _, ct = _cfgs(dtype)
    params = compat.params_from_jax(ct, tree_np, device="cpu")
    for p in tree.leaves(params):
        p.requires_grad_(True)
    lt, _ = ttrainer.make_loss_fn(ct, ttrainer.RunConfig(remat=remat))(
        params, {k: torch.from_numpy(v) for k, v in b.items()})
    gt = torch.autograd.grad(lt, tree.leaves(params))
    return float(lt.detach()), compat.params_to_jax(ct, tree.rebuild(params, list(gt)))


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
def test_model_grads_match_jax_fp32(remat):
    """The gradients of the model alone (``sum(hidden * r)`` through
    api.forward_hidden, the chunked time_mix under autograd), under each remat
    policy: every leaf at 1e-4, its absolute floor 1e-5 of the leaf's largest
    value (these gradients run up to ~20)."""
    cj, ct = _cfgs()
    tree_np = rwkv_numpy_params(cj, 14, GRAD_DECAY_HI)
    rng = np.random.default_rng(15)
    toks = rng.integers(0, ct.vocab_size, (2, 20))
    r = rng.standard_normal((2, 20, ct.d_model)).astype(np.float32)

    def fj(p):
        h, _ = japi.forward_hidden(cj, p, {"tokens": jnp.asarray(toks)}, remat="none")
        return jnp.sum(h * r)

    gj = jax.grad(fj)(jax.tree.map(jnp.asarray, tree_np))
    pt = compat.params_from_jax(ct, tree_np, device="cpu")
    for p in tree.leaves(pt):
        p.requires_grad_(True)
    h, _ = tapi.forward_hidden(ct, pt, {"tokens": torch.from_numpy(toks)}, remat=remat)
    gt = torch.autograd.grad((h * torch.from_numpy(r)).sum(), tree.leaves(pt),
                             allow_unused=True, materialize_grads=True)
    back = compat.params_to_jax(ct, tree.rebuild(pt, list(gt)))
    for (path, want), got in zip(jax.tree_util.tree_leaves_with_path(gj), jax.tree.leaves(back)):
        want = np.asarray(want)
        np.testing.assert_allclose(got, want, rtol=F32_GRADS["rtol"],
                                   atol=F32_GRADS["atol"] * float(np.abs(want).max()),
                                   err_msg=jax.tree_util.keystr(path))


# the step-1 gradients through the loss: its logits matmul takes bf16 operands on
# both sides (ROADMAP C13), so the fp32 model's last-bit differences flip a few of
# its roundings and every gradient moves by ~1e-4 of its norm (read: at most
# 1.35e-4); the model's own gradients agree elementwise (above)
LOSS_GRAD_REL = 5e-4


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
def test_step1_grads_match_jax_fp32(remat, jax_grads):
    """Through the port's trainer: the loss at 1e-5, every gradient leaf
    within LOSS_GRAD_REL of the reference's in norm, the unembedding's
    elementwise up to bf16 flips of the loss's weight gradient."""
    tree_np, b, lj, gj = jax_grads
    lt, back = _port_step1("float32", tree_np, b, remat)
    assert lt == pytest.approx(lj, rel=1e-5)
    assert jax.tree.structure(back) == jax.tree.structure(gj)
    assert float(np.abs(back["blocks"]["block"]["tmix"]["decay"]).sum()) > 0
    for (path, want), got in zip(jax.tree_util.tree_leaves_with_path(gj), jax.tree.leaves(back)):
        name, want = jax.tree_util.keystr(path), np.asarray(want)
        assert np.linalg.norm(got - want) / np.linalg.norm(want) < LOSS_GRAD_REL, name
        if name == "['unembed']['w']":
            _close_but_bf16_flips(got, want, name)


@pytest.mark.parametrize("part", ["tmix", "cmix"])
def test_block_grads_match_jax_bf16(part):
    """The C13 probe for this family: under jax.grad with a bf16 input, XLA
    computes time_mix's and channel_mix's products in fp32 as the source
    reads (every weight widened, the output rounded to bf16 once), so autograd
    of the port's block matches it: every parameter's and the input's gradient
    within 1e-4 of the reference's in norm (read: at most 1.3e-5). (Through the
    whole bf16 model the gradients are no such check: at a token whose group
    norm sees a near-constant head, rsqrt(var + 1e-5) magnifies the bf16
    roundings of the layer below, and the two frameworks' step-1 gradients
    part by up to 10x at the same loss, while at the same block inputs both
    compute the same large gradient.)"""
    cj, ct = _cfgs("bfloat16")
    _, pj, pt = _both_params(cj, ct, 16)
    pj, pt = _layer0(pj, pt, part)
    rng = np.random.default_rng(17)
    x = rng.standard_normal((2, 20, ct.d_model)).astype(np.float32)
    gy = rng.standard_normal((2, 20, ct.d_model)).astype(np.float32)
    st = _state(ct, 2, rng)

    def jfn(p, x):
        xb = x.astype(jnp.bfloat16)
        if part == "tmix":
            y = jrwkv.time_mix(p, xb, cj, S0=jnp.asarray(st["S"]),
                               x_prev=jnp.asarray(st["x_att"]), chunk=8)[0]
        else:
            y = jrwkv.channel_mix(p, xb, x_prev=jnp.asarray(st["x_cmix"]))[0]
        return jnp.sum(y.astype(jnp.float32) * gy)

    gpj, gxj = jax.grad(jfn, argnums=(0, 1))(pj, jnp.asarray(x))
    leaves = tree.leaves(pt)
    for p in leaves:
        p.requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    if part == "tmix":
        y = trwkv.time_mix(pt, xt.bfloat16(), ct, S0=torch.from_numpy(st["S"]),
                           x_prev=torch.from_numpy(st["x_att"]), chunk=8)[0]
    else:
        y = trwkv.channel_mix(pt, xt.bfloat16(), x_prev=torch.from_numpy(st["x_cmix"]))[0]
    assert y.dtype == torch.bfloat16
    grads = torch.autograd.grad((y.float() * torch.from_numpy(gy)).sum(), leaves + [xt])
    for (path, want), got in zip(jax.tree_util.tree_leaves_with_path(gpj) + [((), gxj)],
                                 [g.numpy() for g in grads]):
        want = np.asarray(want, np.float32)
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert rel < 1e-4, (part, jax.tree_util.keystr(path) or "x", rel)


def test_step1_loss_matches_jax_bf16():
    """bf16 compute: step 1's loss through the trainer within 1e-3 of the
    reference's."""
    tree_np, b, lj, _ = _jax_step1("bfloat16", 11)
    lt, _ = _port_step1("bfloat16", tree_np, b, "none")
    assert lt == pytest.approx(lj, rel=1e-3)


@pytest.mark.parametrize("arch", [ARCH, "whisper-large-v3"])
def test_adamw_decays_what_the_reference_decays(arch):
    """One AdamW step at weight decay 0.1 from the same parameters and gradients
    (ROADMAP C20): the reference decays every leaf of 2 dims or more as it
    stores them, so the stacked 1-d maa_x, maa_k, maa_r and decay and the 2-d u
    are decayed, the LayerNorms (ln_x among them) and biases are not."""
    cj, ct = jregistry.get(arch).reduced(), tregistry.get(arch).reduced()
    tree_np = rwkv_numpy_params(cj, 12) if arch == ARCH else numpy_params(cj, 12)
    rng = np.random.default_rng(13)
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
    decayed = {path for path, p in tree.leaves_with_paths(pt)
               if topt._decay_mask(path) and topt.reference_ndim(path, p) >= 2}
    if arch == ARCH:
        for leaf in (("tmix", "maa_x"), ("tmix", "decay"), ("tmix", "u"), ("cmix", "maa_r")):
            assert ("blocks", 1, "block") + leaf in decayed
        assert ("blocks", 0, "block", "tmix", "ln_x", "scale") not in decayed
        assert ("ln0", "bias") not in decayed
    else:
        assert ("pos_dec",) in decayed and ("dec_blocks", 0, "xattn", "wq", "w") in decayed
        assert ("dec_blocks", 1, "xattn_norm", "scale") not in decayed
        assert ("enc_blocks", 0, "mlp", "wu", "b") not in decayed


def test_train_step_runs_for_the_ssm():
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
