"""The port's encoder-decoder family (``models/encdec.py``, whisper-large-v3)
against the JAX package's: the encoder, the teacher-forced decoder, prefill +
decode (cache and logits) and the step-1 loss and gradients through the
trainer, ``cast_params``, the parameter hand-over, the engine's refusal
(ROADMAP C21) and the cross-attention's dispatch (C22).

Weights and inputs are made by numpy from a seed in the JAX layout and handed
to both sides (``repro_torch.compat``). The model runs at reduced width (2
encoder and 2 decoder layers, d_model 64, 4 heads of 16) over 24 frames, so that
every cross-attention has L != S. Tolerances: fp32 2e-5 (the reference's own,
``tests/test_kernels.py::_tol``), greedy tokens exact in fp32; bf16 model
outputs at ``test_torch_models.BF16`` (5e-2), as every bf16 model comparison of
the port: the two frameworks round matmul and attention outputs to bf16 at
other places, so at 2e-2 one to three elements of a few thousand sit two to
four bf16 ulps apart after two layers.
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
from repro.models import attention as jattention
from repro.models import encdec as jencdec
from repro.serve import engine as jengine
from repro.train import trainer as jtrainer
from repro_torch import compat, tree
from repro_torch.configs import registry as tregistry
from repro_torch.kernels import flash_decode as tfd
from repro_torch.models import api as tapi
from repro_torch.models import attention as tattention
from repro_torch.models import encdec as tencdec
from repro_torch.models import transformer as ttransformer
from repro_torch.serve import engine as tengine
from repro_torch.train import trainer as ttrainer

from test_torch_models import (BF16, numpy_params,  # noqa: F401
                               reference_mlp_follows_compute_dtype)
from test_torch_moe import F32_GRADS, _close_but_bf16_flips

ARCH = "whisper-large-v3"
TOL = {"float32": dict(atol=2e-5, rtol=2e-5), "bfloat16": BF16}
S_ENC, S_DEC = 24, 13


def _cfgs(dtype="float32"):
    cj = dataclasses.replace(jregistry.get(ARCH).reduced(), compute_dtype=dtype)
    ct = dataclasses.replace(tregistry.get(ARCH).reduced(), compute_dtype=dtype)
    return cj, ct


def _both_params(cj, ct, seed):
    tree_np = numpy_params(cj, seed)
    return tree_np, jax.tree.map(jnp.asarray, tree_np), compat.params_from_jax(
        ct, tree_np, device="cpu")


def _inputs(ct, seed, B=2, S=S_DEC + 1):
    rng = np.random.default_rng(seed)
    frames = (0.5 * rng.standard_normal((B, S_ENC, ct.d_model))).astype(np.float32)
    toks = rng.integers(0, ct.vocab_size, (B, S))
    return frames, toks


def _close(t, j, tol, what=""):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32), **tol,
                               err_msg=what)


@pytest.fixture(params=["float32", "bfloat16"])
def dtype(request):
    """fp32 with the reference's MLP at fp32 too (its block runs the MLP in bf16
    whatever the config says; the port's follows the config), bf16 as it is."""
    if request.param == "float32":
        request.getfixturevalue("reference_mlp_follows_compute_dtype")
    return request.param


# ---------------------------------------------------------------------------
# the encoder and the teacher-forced decoder
# ---------------------------------------------------------------------------

def test_encode_matches_jax(dtype):
    """The non-causal encoder: 24 frames through 2 layers and the final norm."""
    cj, ct = _cfgs(dtype)
    _, pj, pt = _both_params(cj, ct, 0)
    frames, _ = _inputs(ct, 1)
    ej = jencdec.encode(cj, pj, jnp.asarray(frames), remat="none")
    with torch.no_grad():
        et = tencdec.encode(ct, pt, torch.from_numpy(frames), remat="none")
    assert et.dtype == getattr(torch, dtype) and et.shape == (2, S_ENC, ct.d_model)
    _close(et, ej, TOL[dtype], "encoder hidden")


def test_encoder_is_not_causal():
    """A frame's encoding moves when a later frame changes (bidirectional)."""
    _, ct = _cfgs()
    pt = tapi.init(ct, 0, device="cpu")
    frames = torch.from_numpy(_inputs(ct, 2)[0])
    later = frames.clone()
    later[:, -1] += 1.0
    with torch.no_grad():
        a = tencdec.encode(ct, pt, frames, remat="none")
        b = tencdec.encode(ct, pt, later, remat="none")
    assert not torch.allclose(a[:, 0], b[:, 0])


def test_decode_train_and_forward_match_jax(dtype):
    """decode_train on the JAX encoder's output, and api.forward_hidden / unembed
    end to end (``apply_encdec``'s logits)."""
    cj, ct = _cfgs(dtype)
    _, pj, pt = _both_params(cj, ct, 3)
    frames, toks = _inputs(ct, 4)
    enc_j = jencdec.encode(cj, pj, jnp.asarray(frames), remat="none")
    hj = jencdec.decode_train(cj, pj, jnp.asarray(toks), enc_j, remat="none")
    with torch.no_grad():
        enc_t = torch.from_numpy(np.array(enc_j, np.float32)).to(getattr(torch, dtype))
        ht = tencdec.decode_train(ct, pt, torch.from_numpy(toks), enc_t, remat="none")
        bt = {"tokens": torch.from_numpy(toks), "frames": torch.from_numpy(frames)}
        ft, aux = tapi.forward_hidden(ct, pt, bt, remat="none")
        lt = tencdec.apply_encdec(ct, pt, bt["frames"], bt["tokens"], remat="none")
    assert ht.shape == (2, S_DEC + 1, ct.d_model) and aux == 0.0
    _close(ht, hj, TOL[dtype], "decode_train hidden")
    fj, _ = japi.forward_hidden(cj, pj, {"tokens": jnp.asarray(toks),
                                         "frames": jnp.asarray(frames)}, remat="none")
    _close(ft, fj, TOL[dtype], "forward hidden")
    lj = jencdec.apply_encdec(cj, pj, jnp.asarray(frames), jnp.asarray(toks), remat="none")
    _close(lt, lj, TOL[dtype], "logits")
    _close(tapi.unembed(ct, pt, ft), japi.unembed(cj, pj, fj), TOL[dtype], "unembed")
    np.testing.assert_array_equal(tapi.unembed_table(ct, pt).numpy(),
                                  np.asarray(japi.unembed_table(cj, pj)))


# ---------------------------------------------------------------------------
# serving: prefill + decode
# ---------------------------------------------------------------------------

def test_prefill_cache_and_decode_match_jax(dtype):
    """api.prefill's hidden states and its four caches, then two decode steps'
    logits and caches (the cross K/V untouched, the self K/V written at idx)."""
    cj, ct = _cfgs(dtype)
    _, pj, pt = _both_params(cj, ct, 5)
    frames, toks = _inputs(ct, 6, S=S_DEC + 2)
    S_max = 20
    bj = {"tokens": jnp.asarray(toks[:, :S_DEC]), "frames": jnp.asarray(frames)}
    bt = {"tokens": torch.from_numpy(toks[:, :S_DEC]), "frames": torch.from_numpy(frames)}
    hj, cj_cache = japi.prefill(cj, pj, bj, max_seq=S_max, remat="none")
    with torch.no_grad():
        ht, ct_cache = tapi.prefill(ct, pt, bt, max_seq=S_max)
    assert ct_cache["idx"] == S_DEC == int(cj_cache["idx"])
    shapes = {"k": (ct.dec_layers, 2, S_max, ct.num_kv_heads, ct.head_dim),
              "cross_k": (ct.dec_layers, 2, S_ENC, ct.num_kv_heads, ct.head_dim)}
    _close(ht, hj, TOL[dtype], "prefill hidden")

    def caches_close(when, jcache):
        for key in ("k", "v", "cross_k", "cross_v"):
            assert ct_cache[key].shape == shapes[key.replace("v", "k")], key
            assert ct_cache[key].dtype == getattr(torch, dtype)
            _close(ct_cache[key], jcache[key], TOL[dtype], f"{when} {key}")

    caches_close("prefill", cj_cache)
    for t in (S_DEC, S_DEC + 1):
        lj, cj_cache = japi.decode(cj, pj, cj_cache, jnp.asarray(toks[:, t:t + 1]))
        with torch.no_grad():
            lt, same = tapi.decode(ct, pt, ct_cache, torch.from_numpy(toks[:, t:t + 1]))
        assert same is ct_cache and ct_cache["idx"] == t + 1          # updated in place
        assert lt.shape == (2, 1, ct.vocab_size)
        _close(lt, lj, TOL[dtype], f"decode logits at {t}")
        caches_close(f"decode at {t}", cj_cache)


def test_decode_matches_full_forward():
    """As the JAX package's test of the same name: bf16 compute, the decode
    step's logits against the full forward's last position."""
    _, ct = _cfgs("bfloat16")
    pt = tapi.init(ct, 0, device="cpu")
    frames, toks = _inputs(ct, 7)
    frames, toks = torch.from_numpy(frames), torch.from_numpy(toks)
    with torch.no_grad():
        hidden, _ = tapi.forward_hidden(ct, pt, {"tokens": toks, "frames": frames},
                                        remat="none")
        logits_full = tapi.unembed(ct, pt, hidden[:, -1:])
        _, cache = tapi.prefill(ct, pt, {"tokens": toks[:, :S_DEC], "frames": frames},
                                max_seq=S_DEC + 8)
        logits_dec, _ = tapi.decode(ct, pt, cache, toks[:, S_DEC:])
    np.testing.assert_allclose(logits_dec.float().numpy(), logits_full.float().numpy(),
                               atol=2e-2, rtol=2e-2)


def test_greedy_tokens_identical_to_jax(reference_mlp_follows_compute_dtype):
    """fp32: 6 greedy tokens after a prefill, fed back one step at a time."""
    cj, ct = _cfgs()
    _, pj, pt = _both_params(cj, ct, 8)
    frames, toks = _inputs(ct, 9, S=S_DEC)
    _, cache_j = japi.prefill(cj, pj, {"tokens": jnp.asarray(toks),
                                       "frames": jnp.asarray(frames)}, max_seq=24)
    with torch.no_grad():
        _, cache_t = tapi.prefill(ct, pt, {"tokens": torch.from_numpy(toks),
                                           "frames": torch.from_numpy(frames)}, max_seq=24)
    nj, nt, out_j, out_t = toks[:, -1:], torch.from_numpy(toks[:, -1:]), [], []
    for _ in range(6):
        lj, cache_j = japi.decode(cj, pj, cache_j, jnp.asarray(nj))
        with torch.no_grad():
            lt, cache_t = tapi.decode(ct, pt, cache_t, nt)
        nj = np.asarray(jnp.argmax(lj, axis=-1))
        nt = torch.argmax(lt, dim=-1)
        out_j.append(nj[:, 0].tolist())
        out_t.append(nt[:, 0].tolist())
    assert out_t == out_j


def test_prefill_ignores_attn_fn_as_the_reference():
    """The reference's encdec prefill takes no attn_fn; api.prefill drops the
    knob's: a chunk-4 flash_ref gives the same hidden states as none."""
    _, ct = _cfgs()
    pt = tapi.init(ct, 1, device="cpu")
    frames, toks = _inputs(ct, 10, S=S_DEC)
    b = {"tokens": torch.from_numpy(toks), "frames": torch.from_numpy(frames)}

    def boom(*a, **kw):
        raise AssertionError("attn_fn was called")

    with torch.no_grad():
        h0, _ = tapi.prefill(ct, pt, b)
        h1, _ = tapi.prefill(ct, pt, b, attn_fn=boom)
    assert torch.equal(h0, h1)


def test_encoder_calls_attn_fn_non_causal():
    """A given attn_fn runs the encoder's self-attention non-causal and the
    decoder's causal; the cross-attention never calls it (as in the reference).
    The reference's encoder calls it with ``causal=cfg.causal`` (True for
    whisper): a deviation on purpose (ROADMAP C24)."""
    _, ct = _cfgs()
    pt = tapi.init(ct, 2, device="cpu")
    frames, toks = _inputs(ct, 19, S=S_DEC)
    seen = []

    def recording(q, k, v, *, causal):
        seen.append((q.shape[1], k.shape[1], causal))
        return tattention.flash_ref(q, k, v, causal=causal)

    with torch.no_grad():
        h, _ = tapi.forward_hidden(ct, pt, {"tokens": torch.from_numpy(toks),
                                            "frames": torch.from_numpy(frames)},
                                   attn_fn=recording, remat="none")
        h0, _ = tapi.forward_hidden(ct, pt, {"tokens": torch.from_numpy(toks),
                                             "frames": torch.from_numpy(frames)}, remat="none")
    assert seen == [(S_ENC, S_ENC, False)] * ct.enc_layers + [(S_DEC, S_DEC, True)] * ct.dec_layers
    _close(h, h0.numpy(), TOL["float32"])


def test_init_cache_takes_s_enc():
    _, ct = _cfgs()
    cache = tapi.init_cache(ct, 3, 16, device="cpu")
    assert cache["cross_k"].shape == (ct.dec_layers, 3, ct.frontend_len, ct.num_kv_heads,
                                      ct.head_dim)
    assert tapi.init_cache(ct, 3, 16, s_enc=40, device="cpu")["cross_v"].shape[2] == 40
    assert cache["k"].shape[2] == 16 and cache["idx"] == 0
    jcache = jax.eval_shape(lambda: japi.init_cache(jregistry.get(ARCH).reduced(), 3, 16))
    for key in ("k", "v", "cross_k", "cross_v"):
        assert cache[key].shape == jcache[key].shape


# ---------------------------------------------------------------------------
# the cross-attention's dispatch (ROADMAP C22)
# ---------------------------------------------------------------------------

def _qkv(L, S, seed, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn((2, L, 4, 16), generator=g).to(dtype)
    k = torch.randn((2, S, 4, 16), generator=g).to(dtype)
    v = torch.randn((2, S, 4, 16), generator=g).to(dtype)
    return q, k, v


@pytest.mark.parametrize("L", [1, 9])
def test_cross_attention_on_cpu_equals_flash_ref(L):
    """On CPU tensors the cross-attention (decode route at L == 1, non-causal
    forward otherwise) equals the reference's flash_ref(causal=False)."""
    q, k, v = _qkv(L, 37, 11)
    got = tattention.cross_attend(q, k, v)
    want = jattention.flash_ref(*(jnp.asarray(t.numpy()) for t in (q, k, v)), causal=False)
    _close(got, want, TOL["float32"])
    _close(got, tattention.flash_ref(q, k, v, causal=False), TOL["float32"])


def test_cross_attention_routes(monkeypatch):
    """L == 1 goes through ops.decode_forward at cache_len = S (under
    mode="reference" the plain decode), L > 1 through the non-causal forward,
    a given attn_fn is called with causal=False, and one token under autograd
    takes the forward, which has a backward."""
    from repro_torch.kernels import ops
    seen = []
    dec, fwd = ops.decode_forward, ops.mha_forward
    monkeypatch.setattr(ops, "decode_forward",
                        lambda *a, **kw: seen.append(("decode", a[3], kw)) or dec(*a, **kw))
    monkeypatch.setattr(ops, "mha_forward",
                        lambda *a, **kw: seen.append(("forward", kw)) or fwd(*a, **kw))
    q, k, v = _qkv(1, 21, 12)
    got = tattention.cross_attend(q, k, v, mode="reference")
    want = tfd.flash_decode_plain(q[:, 0], k.transpose(1, 2), v.transpose(1, 2), 21)
    assert torch.equal(got[:, 0], want)
    assert seen == [("decode", 21, {"mode": "reference"})]
    q9 = _qkv(9, 21, 13)[0]
    tattention.cross_attend(q9, k, v)
    assert seen[-1] == ("forward", {"causal": False, "mode": None})
    calls = []
    tattention.cross_attend(q9, k, v, attn_fn=lambda *a, **kw: calls.append(kw) or a[0])
    assert calls == [{"causal": False}] and len(seen) == 2
    qg = q.clone().requires_grad_(True)
    tattention.cross_attend(qg, k, v).sum().backward()
    assert seen[-1][0] == "forward" and float(qg.grad.abs().sum()) > 0


# ---------------------------------------------------------------------------
# cast_params, the hand-over, the engine, the trainer
# ---------------------------------------------------------------------------

ENCDEC_NORMS = ("xattn_norm", "enc_norm", "dec_norm")


def test_cast_params_keeps_the_encdec_norms_fp32(monkeypatch):
    """bf16 compute: the same hidden states and logits with and without the
    cast; xattn_norm, enc_norm and dec_norm still fp32 (apply_norm multiplies
    in fp32), emb, pos_dec and the dense leaves bf16. Without the three keys
    (the rule before the encdec was ported) the numbers move, with no error."""
    cj, ct = _cfgs("bfloat16")
    _, _, pt = _both_params(cj, ct, 14)
    cast = tapi.cast_params(ct, pt)
    for k in ("enc_norm", "dec_norm"):
        assert all(t.dtype == torch.float32 for t in cast[k].values())
    for blk in cast["dec_blocks"]:
        assert blk["xattn_norm"]["scale"].dtype == blk["xattn_norm"]["bias"].dtype == torch.float32
        assert blk["xattn"]["wk"]["w"].dtype == blk["xattn"]["wk"]["b"].dtype == torch.bfloat16
        assert blk["mlp"]["wu"]["w"].dtype == torch.bfloat16
    assert cast["emb"]["table"].dtype == cast["pos_dec"].dtype == torch.bfloat16
    assert cast["enc_blocks"][0]["attn_norm"]["scale"].dtype == torch.float32

    frames, toks = _inputs(ct, 15)
    b = {"tokens": torch.from_numpy(toks[:, :S_DEC]), "frames": torch.from_numpy(frames)}

    def run(params):
        with torch.no_grad():
            h, c = tapi.prefill(ct, params, b, max_seq=16)
            lg, _ = tapi.decode(ct, params, c, torch.from_numpy(toks[:, S_DEC:]))
        return h, lg

    h1, l1 = run(pt)
    h2, l2 = run(cast)
    assert torch.equal(h1, h2) and torch.equal(l1, l2)
    monkeypatch.setattr(ttransformer, "_FP32_KEYS", tuple(
        k for k in ttransformer._FP32_KEYS if k not in ENCDEC_NORMS))
    h3, _ = run(tapi.cast_params(ct, pt))
    assert not torch.equal(h1, h3)


def test_compat_round_trip_of_enc_and_dec_blocks():
    """enc_blocks and dec_blocks stacked on one dim there, lists here; the rest
    crosses as it is; the port's own init restacks to the JAX shapes."""
    cj, ct = _cfgs()
    tree_np = numpy_params(cj, 16)
    pt = compat.params_from_jax(ct, tree_np, device="cpu")
    assert len(pt["enc_blocks"]) == ct.enc_layers and len(pt["dec_blocks"]) == ct.dec_layers
    np.testing.assert_array_equal(pt["dec_blocks"][1]["xattn"]["wq"]["w"].numpy(),
                                  tree_np["dec_blocks"]["xattn"]["wq"]["w"][1])
    np.testing.assert_array_equal(pt["enc_blocks"][0]["mlp"]["wd"]["b"].numpy(),
                                  tree_np["enc_blocks"]["mlp"]["wd"]["b"][0])
    np.testing.assert_array_equal(pt["pos_dec"].numpy(), tree_np["pos_dec"])
    back = compat.params_to_jax(ct, pt)
    assert jax.tree.structure(back) == jax.tree.structure(tree_np)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree_np)):
        np.testing.assert_array_equal(a, b)
    shapes = jax.eval_shape(lambda: japi.init(cj, jax.random.PRNGKey(0)))
    mine = compat.params_to_jax(ct, tapi.init(ct, 0, device="cpu"))
    assert jax.tree.structure(mine) == jax.tree.structure(shapes)
    for a, s in zip(jax.tree.leaves(mine), jax.tree.leaves(shapes)):
        assert a.shape == s.shape and a.dtype == np.float32


def test_engine_refuses_encdec_as_the_reference_cannot_serve_it():
    """ROADMAP C21: the JAX engine's prefill passes tokens alone and fails on
    the missing frames; the port's engine refuses at construction, by name."""
    cj, ct = _cfgs()
    tree_np, pj, pt = _both_params(cj, ct, 17)
    ej = jengine.ServeEngine(cj, pj, slots=1, max_seq=16)
    ej.submit(jengine.Request(rid=0, prompt=np.arange(5), max_new=2))
    with pytest.raises(KeyError, match="frames"):
        ej.step()
    with pytest.raises(NotImplementedError, match="encdec.*frames"):
        tengine.ServeEngine(ct, pt, slots=1, max_seq=16, device="cpu")


def test_serve_launcher_hands_the_engine_error_on():
    from repro_torch.launch import serve
    with pytest.raises(NotImplementedError, match="cannot serve the encdec family"):
        serve.main(["--device", "cpu", "--arch", ARCH, "--requests", "1"])


@pytest.fixture(scope="module")
def jax_grads():
    """Step-1 loss and gradients of the JAX package at fp32 (its MLP at fp32 too)."""
    from functools import partial
    from repro.models import layers as jl
    cj, _ = _cfgs()
    tree_np = numpy_params(cj, 18)
    b = token_batch(cj, batch=2, seq=12, step=0)
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
    """Every gradient leaf at 1e-4 through the port's loss (the encoder's
    non-causal forward and the cross-attention under autograd); the tied
    embedding's up to bf16 flips of the loss's weight gradient (ROADMAP C13)."""
    tree_np, b, lj, gj = jax_grads
    _, ct = _cfgs()
    params = compat.params_from_jax(ct, tree_np, device="cpu")
    for p in tree.leaves(params):
        p.requires_grad_(True)
    lt, _ = ttrainer.make_loss_fn(ct, ttrainer.RunConfig(remat=remat))(
        params, {k: torch.from_numpy(v) for k, v in b.items()})
    assert float(lt.detach()) == pytest.approx(lj, rel=1e-5)
    gt = torch.autograd.grad(lt, tree.leaves(params))
    back = compat.params_to_jax(ct, tree.rebuild(params, list(gt)))
    assert jax.tree.structure(back) == jax.tree.structure(gj)
    assert float(np.abs(back["enc_blocks"]["attn"]["wq"]["w"]).sum()) > 0
    assert float(np.abs(back["dec_blocks"]["xattn"]["wk"]["w"]).sum()) > 0
    for (path, want), got in zip(jax.tree_util.tree_leaves_with_path(gj), jax.tree.leaves(back)):
        name = jax.tree_util.keystr(path)
        if name == "['emb']['table']":
            _close_but_bf16_flips(got, np.asarray(want), name)
        else:
            np.testing.assert_allclose(got, np.asarray(want), **F32_GRADS, err_msg=name)


def test_train_step_runs_for_the_encdec():
    """make_train_step end to end at the default remat, bf16 compute: three
    steps on the synthetic frames, finite and falling loss."""
    from repro_torch.data.synthetic import token_batch as tbatch
    from repro_torch.train import optimizer as topt
    _, ct = _cfgs("bfloat16")
    run = ttrainer.RunConfig(opt=topt.OptConfig(lr=3e-3, warmup_steps=1, total_steps=10))
    state = ttrainer.init_state(ct, run, 0, device="cpu")
    step = ttrainer.make_train_step(ct, run)
    batch = {k: torch.from_numpy(v) for k, v in tbatch(ct, batch=4, seq=16, step=0).items()}
    assert batch["frames"].shape == (4, ct.frontend_len, ct.d_model)
    losses = []
    for _ in range(3):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
