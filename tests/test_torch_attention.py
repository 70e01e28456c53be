"""Port vs JAX package for ``models/attention``.

Same numpy-seeded inputs on both sides. fp32 is held to 2e-5 (same arithmetic,
other summation order and exp), bf16 to 2e-2 (one rounding of an O(1) result
to 8 bits of mantissa, at other places in the two frameworks).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models import attention as ja
from repro_torch.configs import registry as tregistry
from repro_torch.models import attention as ta

F32 = dict(atol=2e-5, rtol=2e-5)
BF16 = dict(atol=2e-2, rtol=2e-2)


def _qkv(B, L, S, H, Hkv, D, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, L, H, D), dtype=np.float32),
            rng.standard_normal((B, S, Hkv, D), dtype=np.float32),
            rng.standard_normal((B, S, Hkv, D), dtype=np.float32))


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a)).to(dtype)


def _j(a, dtype=jnp.float32):
    return jnp.asarray(a).astype(dtype)


def _close(t, j, tol):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32), **tol)


@pytest.mark.parametrize("causal,q_offset,L,S", [
    (True, 0, 48, 48), (False, 0, 20, 48), (True, 28, 20, 48)])
def test_attention_naive(causal, q_offset, L, S):
    q, k, v = _qkv(2, L, S, 4, 2, 16)
    _close(ta.attention_naive(_t(q), _t(k), _t(v), causal=causal, q_offset=q_offset),
           ja.attention_naive(_j(q), _j(k), _j(v), causal=causal, q_offset=q_offset), F32)


@pytest.mark.parametrize("causal,q_offset,L,S,chunk", [
    (True, 0, 48, 48, 16), (True, 0, 50, 50, 16), (False, 0, 20, 50, 512),
    (True, 30, 20, 50, 16), (True, 0, 33, 33, 512)])
def test_flash_ref_fp32(causal, q_offset, L, S, chunk):
    q, k, v = _qkv(2, L, S, 4, 2, 16, seed=1)
    kw = dict(causal=causal, q_offset=q_offset, chunk=chunk)
    out = ta.flash_ref(_t(q), _t(k), _t(v), **kw)
    _close(out, ja.flash_ref(_j(q), _j(k), _j(v), **kw), F32)
    _close(out, ja.attention_naive(_j(q), _j(k), _j(v), causal=causal, q_offset=q_offset), F32)


@pytest.mark.parametrize("pv_bf16", [False, True])
def test_flash_ref_bf16_and_pv_bf16(pv_bf16):
    q, k, v = _qkv(1, 40, 40, 4, 1, 32, seed=2)
    bt, bj = torch.bfloat16, jnp.bfloat16
    out = ta.flash_ref(_t(q, bt), _t(k, bt), _t(v, bt), causal=True, chunk=16, pv_bf16=pv_bf16)
    assert out.dtype == bt
    _close(out, ja.flash_ref(_j(q, bj), _j(k, bj), _j(v, bj), causal=True, chunk=16,
                             pv_bf16=pv_bf16), BF16)


def test_flash_ref_pv_bf16_fp32_inputs():
    q, k, v = _qkv(1, 24, 24, 2, 2, 16, seed=3)
    out = ta.flash_ref(_t(q), _t(k), _t(v), causal=True, chunk=8, pv_bf16=True)
    ref = ja.flash_ref(_j(q), _j(k), _j(v), causal=True, chunk=8, pv_bf16=True)
    # P and V rounded to bf16 on both sides, products summed in fp32: a P that
    # rounds the other way on one side moves the result by up to 2^-9 of a term
    _close(out, ref, dict(atol=2e-3, rtol=2e-3))


@pytest.mark.parametrize("clen", [1, 17, 64])
def test_decode_attend(clen):
    q, k, v = _qkv(2, 1, 64, 8, 2, 16, seed=4)
    _close(ta.decode_attend(_t(q), _t(k), _t(v), clen),
           ja.decode_attend(_j(q), _j(k), _j(v), clen), F32)


def test_decode_attend_per_row_lengths():
    q, k, v = _qkv(3, 1, 32, 4, 4, 16, seed=5)
    lens = np.array([3, 32, 11])
    _close(ta.decode_attend(_t(q), _t(k), _t(v), torch.from_numpy(lens)),
           ja.decode_attend(_j(q), _j(k), _j(v), jnp.asarray(lens)), F32)


def test_decode_attend_bf16():
    q, k, v = _qkv(2, 1, 40, 8, 2, 16, seed=6)
    bt, bj = torch.bfloat16, jnp.bfloat16
    _close(ta.decode_attend(_t(q, bt), _t(k, bt), _t(v, bt), 29),
           ja.decode_attend(_j(q, bj), _j(k, bj), _j(v, bj), 29), BF16)


def test_partial_and_merge():
    B, S, H, Hkv, D, clen = 2, 64, 8, 4, 16, 50
    q, k, v = _qkv(B, 1, S, H, Hkv, D, seed=7)
    parts_t, parts_j = [], []
    for i in range(4):
        sl = slice(i * S // 4, (i + 1) * S // 4)
        valid = np.broadcast_to(np.arange(S)[sl][None, :] < clen, (B, S // 4))
        pt = ta.decode_attend_partial(_t(q), _t(k[:, sl]), _t(v[:, sl]),
                                      torch.from_numpy(valid.copy()))
        pj = ja.decode_attend_partial(_j(q), _j(k[:, sl]), _j(v[:, sl]), jnp.asarray(valid))
        if i < 3:       # the last shard is wholly masked: its (o, m) carry no information
            for a, b in zip(pt, pj):
                _close(a, b, F32)
        parts_t.append(pt)
        parts_j.append(pj)
    mt = ta.merge_partial_attn(*(torch.stack([p[i] for p in parts_t]) for i in range(3)))
    mj = ja.merge_partial_attn(*(jnp.stack([p[i] for p in parts_j]) for i in range(3)))
    _close(mt, mj, F32)
    whole = ta.decode_attend(_t(q), _t(k), _t(v), clen)
    _close(mt[:, 0].reshape(B, 1, H, D), whole.numpy(), F32)


def _attn_params(cfg, seed):
    rng = np.random.default_rng(seed)
    d, hd = cfg.d_model, cfg.head_dim
    shapes = {"wq": (d, cfg.num_heads * hd), "wk": (d, cfg.num_kv_heads * hd),
              "wv": (d, cfg.num_kv_heads * hd), "wo": (cfg.num_heads * hd, d)}
    p = {}
    for n, (di, do) in shapes.items():
        p[n] = {"w": rng.standard_normal((di, do), dtype=np.float32) / np.sqrt(di)}
        if (cfg.qkv_bias or cfg.bias) and n != "wo":
            p[n]["b"] = rng.standard_normal(do, dtype=np.float32) * 0.1
    return p


def _both(p):
    return ({n: {k: _t(a) for k, a in d.items()} for n, d in p.items()},
            {n: {k: _j(a) for k, a in d.items()} for n, d in p.items()})


@pytest.mark.parametrize("dtype,tol", [("float32", F32), ("bfloat16", BF16)])
def test_attn_apply_prefill_and_cached(dtype, tol):
    cj = dataclasses.replace(jregistry.get("qwen2.5-3b").reduced(), compute_dtype=dtype)
    ct = dataclasses.replace(tregistry.get("qwen2.5-3b").reduced(), compute_dtype=dtype)
    pt, pj = _both(_attn_params(ct, 8))
    rng = np.random.default_rng(9)
    B, S, S_max = 2, 10, 16
    x = rng.standard_normal((B, S + 1, ct.d_model), dtype=np.float32)
    pos = np.arange(S)[None, :]

    ot, (kt, vt) = ta.attn_apply(pt, _t(x[:, :S]), ct, positions=torch.from_numpy(pos))
    oj, (kj, vj) = ja.attn_apply(pj, _j(x[:, :S]), cj, positions=jnp.asarray(pos))
    assert ot.dtype == ta.layers.to_dtype(dtype)
    _close(ot, oj, tol)
    _close(kt, kj, tol)
    _close(vt, vj, tol)

    # cached decode of token S: both sides start from the JAX side's K/V
    cdt = ta.layers.to_dtype(dtype)
    kc = np.zeros((B, S_max, ct.num_kv_heads, ct.head_dim), np.float32)
    vc = np.zeros_like(kc)
    kc[:, :S], vc[:, :S] = np.asarray(kj, np.float32), np.asarray(vj, np.float32)
    kct, vct = _t(kc, cdt), _t(vc, cdt)
    ot, (kct2, vct2) = ta.attn_apply(pt, _t(x[:, S:]), ct, positions=torch.full((1, 1), S),
                                     kv_cache=(kct, vct), cache_index=S)
    oj, (kcj2, vcj2) = ja.attn_apply(pj, _j(x[:, S:]), cj, positions=jnp.full((1, 1), S),
                                     kv_cache=(_j(kc, dtype), _j(vc, dtype)), cache_index=S)
    assert kct2 is kct and vct2 is vct          # the port writes the cache in place
    _close(ot, oj, tol)
    _close(kct, kcj2, tol)
    _close(vct, vcj2, tol)
    assert float(kct[:, S + 1:].abs().max()) == 0.0


def test_attn_apply_attn_fn_wins_and_cross_kv():
    ct = dataclasses.replace(tregistry.get("olmo-1b").reduced(), compute_dtype="float32")
    cj = dataclasses.replace(jregistry.get("olmo-1b").reduced(), compute_dtype="float32")
    pt, pj = _both(_attn_params(ct, 10))
    rng = np.random.default_rng(11)
    x = rng.standard_normal((1, 6, ct.d_model), dtype=np.float32)
    pos = np.arange(6)[None, :]
    calls = []

    def spy(q, k, v, *, causal):
        calls.append(causal)
        return ta.flash_ref(q, k, v, causal=causal, chunk=4)

    ot, _ = ta.attn_apply(pt, _t(x), ct, positions=torch.from_numpy(pos), attn_fn=spy)
    oj, _ = ja.attn_apply(pj, _j(x), cj, positions=jnp.asarray(pos))
    assert calls == [True]
    _close(ot, oj, F32)

    ck = rng.standard_normal((1, 9, ct.num_kv_heads, ct.head_dim), dtype=np.float32)
    cv = rng.standard_normal((1, 9, ct.num_kv_heads, ct.head_dim), dtype=np.float32)
    ot, none = ta.attn_apply(pt, _t(x), ct, positions=torch.from_numpy(pos),
                             cross_kv=(_t(ck), _t(cv)), use_rope=False)
    oj, _ = ja.attn_apply(pj, _j(x), cj, positions=jnp.asarray(pos),
                          cross_kv=(_j(ck), _j(cv)), use_rope=False)
    assert none is None
    _close(ot, oj, F32)
