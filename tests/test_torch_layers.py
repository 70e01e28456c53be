"""Port vs JAX package, function by function, for ``models/layers``.

Inputs and weights are made by numpy from a seed and fed to both sides. fp32
results are held to 1e-5: both sides do the same fp32 arithmetic and differ only
in summation order and in the last bits of exp / tanh / rsqrt / sin / cos.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jl
from repro_torch.models import layers as tl

TOL = dict(atol=1e-5, rtol=1e-5)


def _rng():
    return np.random.default_rng(0)


def _pair(a):
    return jnp.asarray(a), torch.from_numpy(np.asarray(a))


def _close(t, j, **tol):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32), **(tol or TOL))


@pytest.mark.parametrize("bias", [False, True])
def test_dense(bias):
    rng = _rng()
    x = rng.standard_normal((2, 5, 32), dtype=np.float32)
    w = rng.standard_normal((32, 48), dtype=np.float32) / np.sqrt(32)
    b = rng.standard_normal((48,), dtype=np.float32)
    pj = {"w": jnp.asarray(w)}
    pt = {"w": torch.from_numpy(w)}
    if bias:
        pj["b"], pt["b"] = _pair(b)
    _close(tl.dense(pt, torch.from_numpy(x), dtype=torch.float32),
           jl.dense(pj, jnp.asarray(x), dtype=jnp.float32))


def test_dense_bf16_output_type():
    rng = _rng()
    x = rng.standard_normal((3, 16), dtype=np.float32)
    w = rng.standard_normal((16, 8), dtype=np.float32) / 4
    yt = tl.dense({"w": torch.from_numpy(w)}, torch.from_numpy(x))
    yj = jl.dense({"w": jnp.asarray(w)}, jnp.asarray(x))
    assert yt.dtype == torch.bfloat16 and yj.dtype == jnp.bfloat16
    # one bf16 rounding of an O(1) result, accumulated in another order
    _close(yt, yj, atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm", "nonparam_ln"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_norm(kind, dtype):
    rng = _rng()
    x = rng.standard_normal((2, 7, 64), dtype=np.float32) * 3 + 1
    pj, pt = {}, {}
    if kind != "nonparam_ln":
        pj["scale"], pt["scale"] = _pair(rng.standard_normal(64, dtype=np.float32))
    if kind == "layernorm":
        pj["bias"], pt["bias"] = _pair(rng.standard_normal(64, dtype=np.float32))
    xt = torch.from_numpy(x).to(tl.to_dtype(dtype))
    xj = jnp.asarray(x).astype(dtype)
    yt, yj = tl.apply_norm(kind, pt, xt), jl.apply_norm(kind, pj, xj)
    assert yt.dtype == xt.dtype
    # fp32 inside on both sides; the bf16 case adds one rounding of the result
    tol = TOL if dtype == "float32" else dict(atol=2e-2, rtol=2e-2)
    _close(yt, yj, **tol)


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm", "nonparam_ln"])
def test_norm_init_matches(kind):
    pj, pt = jl.norm_init(kind, 16), tl.norm_init(kind, 16, device="cpu")
    assert set(pj) == set(pt)
    for k in pj:
        assert pt[k].dtype == torch.float32
        np.testing.assert_array_equal(pt[k].numpy(), np.asarray(pj[k]))


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_rope(theta):
    rng = _rng()
    x = rng.standard_normal((2, 9, 4, 16), dtype=np.float32)
    pos = np.arange(9)[None, :] + 5
    yt = tl.rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    yj = jl.rope(jnp.asarray(x), jnp.asarray(pos), theta)
    _close(yt, yj)


def test_rope_large_positions():
    rng = _rng()
    x = rng.standard_normal((1, 4, 2, 128), dtype=np.float32)
    pos = np.array([[0, 511, 1023, 4095]])
    yt = tl.rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6)
    yj = jl.rope(jnp.asarray(x), jnp.asarray(pos), 1e6)
    # angles up to 4095 rad: sin/cos argument reduction differs in the last
    # bits between the two libraries
    _close(yt, yj, atol=5e-4, rtol=1e-5)


@pytest.mark.parametrize("kind", ["swiglu", "geglu", "gelu_mlp"])
@pytest.mark.parametrize("bias", [False, True])
def test_apply_mlp(kind, bias):
    rng = _rng()
    d, d_ff = 32, 64
    x = rng.standard_normal((2, 5, d), dtype=np.float32)
    names = ("wg", "wu", "wd") if kind != "gelu_mlp" else ("wu", "wd")
    pj, pt = {}, {}
    for n in names:
        di, do = (d_ff, d) if n == "wd" else (d, d_ff)
        w = rng.standard_normal((di, do), dtype=np.float32) / np.sqrt(di)
        pj[n], pt[n] = {"w": jnp.asarray(w)}, {"w": torch.from_numpy(w)}
        if bias:
            pj[n]["b"], pt[n]["b"] = _pair(rng.standard_normal(do, dtype=np.float32))
    yt = tl.apply_mlp(kind, pt, torch.from_numpy(x), dtype=torch.float32)
    yj = jl.apply_mlp(kind, pj, jnp.asarray(x), dtype=jnp.float32)
    _close(yt, yj)


def test_gelu_is_tanh_approximation():
    x = torch.linspace(-4, 4, 101)
    exact = torch.nn.functional.gelu(x)
    assert (tl._gelu(x) - exact).abs().max() > 1e-4      # not torch's default
    import jax
    _close(tl._gelu(x), jax.nn.gelu(jnp.asarray(x.numpy())))


def test_embed():
    rng = _rng()
    table = rng.standard_normal((50, 16), dtype=np.float32)
    toks = rng.integers(0, 50, (2, 6))
    for dj, dt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        yt = tl.embed({"table": torch.from_numpy(table)}, torch.from_numpy(toks), dtype=dt)
        yj = jl.embed({"table": jnp.asarray(table)}, jnp.asarray(toks), dtype=dj)
        assert yt.dtype == dt
        np.testing.assert_array_equal(yt.float().numpy(), np.asarray(yj, np.float32))


def test_seeded_init_shapes_and_statistics():
    gen = torch.Generator().manual_seed(0)
    p = tl.dense_init(gen, 64, 256, bias=True)
    assert p["w"].shape == (64, 256) and p["b"].shape == (256,)
    assert p["w"].dtype == torch.float32 and float(p["b"].abs().max()) == 0.0
    std = 1.0 / np.sqrt(64)
    assert float(p["w"].abs().max()) <= 2 * std + 1e-6        # truncated at 2 sigma
    assert 0.8 * std < float(p["w"].std()) < 0.95 * std       # 0.88 sigma after truncation
    again = tl.dense_init(torch.Generator().manual_seed(0), 64, 256, bias=True)
    assert torch.equal(p["w"], again["w"])
    e = tl.embed_init(torch.Generator().manual_seed(1), 32, 16)
    assert e["table"].shape == (32, 16)
    m = tl.mlp_init(torch.Generator().manual_seed(2), "swiglu", 16, 32)
    assert set(m) == {"wg", "wu", "wd"} and m["wd"]["w"].shape == (32, 16)
    assert set(tl.mlp_init(torch.Generator().manual_seed(2), "gelu_mlp", 16, 32)) == {"wu", "wd"}
