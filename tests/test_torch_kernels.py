"""The port's kernel modules against the JAX package's Pallas kernels.

On the CPU the port's wrappers take the kernels' plain PyTorch versions (the
CUDA kernels themselves are compared with these same plain versions on the card
by ``chip_smoke.py``). Here the plain versions and the ``ops`` entry points are
held against the Pallas kernels run in interpret mode and against the
materialising oracles, over the grid and at the tolerances of
``tests/test_kernels.py``: fp32 2e-5 (same fp32 arithmetic, other summation
order), bf16 2e-2 (one rounding of the output to bf16).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as pallas_fwd
from repro.kernels.flash_decode import flash_decode as pallas_decode
from repro.models.attention import decode_attend, flash_ref
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import flash_decode as tfd
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

gpu = pytest.mark.gpu


def _tol(dtype):
    return dict(atol=2e-2, rtol=2e-2) if dtype == "bfloat16" else dict(atol=2e-5, rtol=2e-5)


def _inputs(shapes, dtype, seed=0):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s, dtype=np.float32) for s in shapes]
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    return ([torch.from_numpy(a).to(tdt) for a in arrs],
            [jnp.asarray(a).astype(dtype) for a in arrs])


def _close(t, j, tol):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32), **tol)


FWD_GRID = [
    (2, 4, 2, 128, 128, 64),
    (1, 8, 2, 256, 256, 128),
    (2, 4, 4, 100, 100, 64),      # non-multiple of block
    (1, 4, 1, 64, 384, 128),      # cross (L != S)
    (1, 2, 2, 192, 192, 112),     # head_dim 112
    (1, 4, 1, 80, 80, 112),       # fp32 kernel: 3 row tiles of 32, the middle one alone
    (1, 2, 1, 300, 300, 128),     # fp32 kernel: 10 row tiles, ragged rows
    (1, 4, 2, 12, 12, 16),        # the launcher's reduced width
]


@pytest.mark.parametrize("B,H,Hkv,L,S,D", FWD_GRID)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_fwd_matches_pallas_and_ref(B, H, Hkv, L, S, D, causal, dtype):
    (q, k, v), (qj, kj, vj) = _inputs([(B, H, L, D), (B, Hkv, S, D), (B, Hkv, S, D)], dtype)
    if causal and L != S:
        # the kernel's causal mask has no query offset: the port refuses the call
        with pytest.raises(ValueError, match="L == S"):
            tfa.flash_attention(q, k, v, causal=True)
        return
    o = tfa.flash_attention(q, k, v, causal=causal)          # CPU tensor -> plain version
    assert o.dtype == q.dtype and o.shape == q.shape
    o_pallas = pallas_fwd(qj, kj, vj, causal=causal, block_q=64, block_k=64, interpret=True)
    _close(o, o_pallas, _tol(dtype))
    _close(o, jref.flash_attention_ref(qj, kj, vj, causal=causal), _tol(dtype))
    _close(tref.flash_attention_ref(q, k, v, causal=causal),
           jref.flash_attention_ref(qj, kj, vj, causal=causal), _tol(dtype))


DECODE_GRID = [
    (2, 8, 2, 512, 64, 300),
    (1, 16, 8, 1024, 128, 1024),
    (2, 4, 4, 256, 64, 1),
    (1, 6, 1, 640, 128, 77),      # G=6, ragged length
    (2, 16, 2, 256, 128, 130),    # G=8, the serving group size
]


@pytest.mark.parametrize("B,H,Hkv,S,D,clen", DECODE_GRID)
@pytest.mark.parametrize("partials", [False, True])
def test_flash_decode_matches_pallas_and_ref(B, H, Hkv, S, D, clen, partials):
    (q, kc, vc), (qj, kcj, vcj) = _inputs([(B, H, D), (B, Hkv, S, D), (B, Hkv, S, D)],
                                          "float32", seed=1)
    tol = _tol("float32")
    o_ref = jref.flash_decode_ref(qj, kcj, vcj, jnp.full((B,), clen))
    if partials:
        acc, m, l = tfd.flash_decode(q, kc, vc, clen, return_partials=True)
        accj, mj, lj = pallas_decode(qj, kcj, vcj, clen, block_k=128,
                                     return_partials=True, interpret=True)
        assert acc.dtype == m.dtype == l.dtype == torch.float32
        assert acc.shape == (B, H, D) and m.shape == (B, H) and l.shape == (B, H)
        _close(m, mj, tol)
        _close(l, lj, tol)
        _close(acc, accj, dict(atol=2e-5, rtol=2e-5))
        o = acc / torch.clamp(l, min=1e-30)[..., None]
    else:
        o = tfd.flash_decode(q, kc, vc, clen)
        _close(o, pallas_decode(qj, kcj, vcj, clen, block_k=128, interpret=True), tol)
    _close(o, o_ref, tol)
    _close(tref.flash_decode_ref(q, kc, vc, clen), o_ref, tol)


def test_flash_decode_bf16_and_length_clamp():
    (q, kc, vc), (qj, kcj, vcj) = _inputs([(2, 8, 64), (2, 2, 128, 64), (2, 2, 128, 64)],
                                          "bfloat16", seed=2)
    o = tfd.flash_decode(q, kc, vc, 100)
    assert o.dtype == torch.bfloat16
    _close(o, pallas_decode(qj, kcj, vcj, 100, block_k=128, interpret=True), _tol("bfloat16"))
    # a length beyond the cache is clamped to it, as the TPU wrapper does
    _close(tfd.flash_decode(q, kc, vc, 10_000),
           pallas_decode(qj, kcj, vcj, 10_000, block_k=128, interpret=True), _tol("bfloat16"))
    with pytest.raises(ValueError, match="cache_len"):
        tfd.flash_decode(q, kc, vc, 0)


def test_plain_block_size_invariance():
    (q, k, v), _ = _inputs([(1, 4, 256, 64), (1, 2, 256, 64), (1, 2, 256, 64)], "float32", 3)
    outs = [tfa.flash_attention_plain(q, k, v, causal=True, block_k=bk)
            for bk in (64, 128, 256, 100)]
    for o in outs[1:]:
        np.testing.assert_allclose(outs[0].numpy(), o.numpy(), atol=1e-5, rtol=1e-5)


def test_ops_mha_forward_matches_jax_ops():
    (q, k, v), (qj, kj, vj) = _inputs([(2, 128, 4, 64), (2, 128, 2, 64), (2, 128, 2, 64)],
                                      "float32", seed=4)
    from repro.kernels import ops as jops
    want = jops.mha_forward(qj, kj, vj, causal=True, mode="interpret", block_q=64, block_k=64)
    tol = dict(atol=1e-5, rtol=1e-5)      # as tests/test_kernels.py holds the two JAX paths
    for mode in (None, "reference"):
        o = tops.mha_forward(q, k, v, causal=True, mode=mode)
        assert o.shape == q.shape
        _close(o, want, tol)
    _close(tops.mha_forward(q, k, v, causal=False),
           jops.mha_forward(qj, kj, vj, causal=False, mode="reference"), tol)


def test_ops_mha_forward_causal_offset_raises():
    (q, k, v), _ = _inputs([(1, 16, 4, 32), (1, 48, 2, 32), (1, 48, 2, 32)], "float32", 5)
    with pytest.raises(ValueError, match="L == S"):
        tops.mha_forward(q, k, v, causal=True)
    with pytest.raises(ValueError, match="L == S"):
        tops.mha_forward(q, k, v, causal=True, mode="reference")
    assert tops.mha_forward(q, k, v, causal=False).shape == q.shape
    with pytest.raises(ValueError, match="mode"):
        tops.mha_forward(q, k, v, causal=False, mode="interpret")


@pytest.mark.parametrize("partials", [False, True])
def test_ops_decode_forward_matches_jax_ops(partials):
    (q, kc, vc), (qj, kcj, vcj) = _inputs([(2, 1, 8, 64), (2, 512, 4, 64), (2, 512, 4, 64)],
                                          "float32", seed=6)
    from repro.kernels import ops as jops
    tol = dict(atol=2e-5, rtol=2e-5)
    for mode in (None, "reference"):
        got = tops.decode_forward(q, kc, vc, 400, mode=mode, return_partials=partials)
        want = jops.decode_forward(qj, kcj, vcj, 400, mode="interpret", block_k=128,
                                   return_partials=partials)
        if partials:
            for a, b in zip(got, want):
                _close(a, b, tol)
        else:
            assert got.shape == (2, 1, 8, 64)
            _close(got, want, tol)


def test_decode_partials_merge_across_sequence_shards():
    """Kernel-side partials of 4 sequence shards, merged, equal the whole."""
    from repro_torch.models import attention as ta
    (q, kc, vc), _ = _inputs([(2, 1, 8, 64), (2, 512, 4, 64), (2, 512, 4, 64)], "float32", 7)
    clen, S = 400, 512
    whole = tops.decode_forward(q, kc, vc, clen)
    parts = []
    for i in range(4):
        lo, hi = i * S // 4, (i + 1) * S // 4
        if clen <= lo:
            continue
        parts.append(tops.decode_forward(q, kc[:, lo:hi], vc[:, lo:hi], clen - lo,
                                         return_partials=True))
    merged = ta.merge_partial_attn(*(torch.stack([p[i] for p in parts]) for i in range(3)))
    np.testing.assert_allclose(merged.reshape(2, 1, 8, 64).numpy(), whole.numpy(),
                               atol=1e-5, rtol=1e-5)


def _counters():
    return (tfa.launches, tfa.launches_sm90, tfa.launches_f32,
            tfd.launches, tfd.launches_sm90, tfd.launches_f32)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    (q, k, v), _ = _inputs([(1, 4, 8, 16), (1, 2, 8, 16), (1, 2, 8, 16)], "float32", 8)
    with pytest.raises(TypeError):
        tfa.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(TypeError):
        tfa.flash_attention(q, k.bfloat16(), v.bfloat16())
    with pytest.raises(ValueError, match="KV heads"):
        tfa.flash_attention(q[:, :3], k, v)
    with pytest.raises(ValueError, match="contiguous"):
        tfa.flash_attention(q.transpose(2, 3), k.transpose(2, 3), v.transpose(2, 3))
    # past the kernels' own limits the CUDA route refuses before any launch (the
    # CPU route takes these sizes: see the *_past_the_kernel_limits tests)
    before = _counters()
    for dt in (torch.float32, torch.bfloat16):
        big = torch.zeros(1, 2, 4, 256, dtype=dt)
        with pytest.raises(ValueError, match="head_dim"):
            tfa._launch(big, big, big, True)
        cache = torch.zeros(1, 2, 8, 16, dtype=dt)
        for launch in (tfd._launch_f32, tfd._launch_sm90):
            with pytest.raises(ValueError, match="16 query heads"):
                launch(torch.zeros(1, 34, 16, dtype=dt), cache, cache, 4, False, 0)
            wide = torch.zeros(1, 2, 8, 256, dtype=dt)
            with pytest.raises(ValueError, match="head_dim"):
                launch(torch.zeros(1, 4, 256, dtype=dt), wide, wide, 4, False, 0)
    assert _counters() == before


def test_f32_launch_refuses_what_the_copies_cannot_read_before_any_launch():
    """The fp32 kernel copies 16-byte chunks of cache rows; the checks come before
    the library is built or called."""
    (q, kc, vc), _ = _inputs([(1, 4, 64), (1, 2, 64, 64), (1, 2, 64, 64)], "float32", 12)
    before = _counters()
    flat = torch.zeros(1 + kc.numel())
    with pytest.raises(ValueError, match="16-byte"):          # base 4 bytes off
        tfd._launch_f32(q, flat[1:].view(kc.shape), vc, 40, False, 0)
    with pytest.raises(ValueError, match="16-byte"):          # a row stride of 66 floats
        tfd._launch_f32(q, kc, torch.zeros(1, 2, 64, 66)[..., :64], 40, True, 0)
    narrow = torch.zeros(1, 2, 64, 18)
    with pytest.raises(ValueError, match="multiple of 4"):
        tfd._launch_f32(torch.zeros(1, 4, 18), narrow, narrow, 40, False, 0)
    assert _counters() == before


DECODE_PAST_LIMITS = [  # B, H, Hkv, S, D, clen
    (1, 4, 2, 96, 256, 70),       # head_dim 256
    (1, 64, 2, 64, 32, 50),       # 32 query heads a KV head
]


@pytest.mark.parametrize("B,H,Hkv,S,D,clen", DECODE_PAST_LIMITS)
@pytest.mark.parametrize("partials", [False, True])
def test_flash_decode_past_the_kernel_limits_matches_the_jax_package(B, H, Hkv, S, D, clen,
                                                                     partials):
    """The CPU route takes what the JAX package takes; only the kernels are bounded."""
    (q, kc, vc), (qj, kcj, vcj) = _inputs([(B, H, D), (B, Hkv, S, D), (B, Hkv, S, D)],
                                          "float32", seed=13)
    tol = _tol("float32")
    before = _counters()
    want = decode_attend(qj[:, None], kcj.transpose(0, 2, 1, 3), vcj.transpose(0, 2, 1, 3),
                         clen)[:, 0]
    if partials:
        acc, m, l = tfd.flash_decode(q, kc, vc, clen, return_partials=True)
        accj, mj, lj = pallas_decode(qj, kcj, vcj, clen, block_k=32, return_partials=True,
                                     interpret=True)
        _close(m, mj, tol)
        _close(l, lj, tol)
        _close(acc, accj, tol)
        o = acc / torch.clamp(l, min=1e-30)[..., None]
    else:
        o = tfd.flash_decode(q, kc, vc, clen)
        _close(o, pallas_decode(qj, kcj, vcj, clen, block_k=32, interpret=True), tol)
    _close(o, want, tol)
    assert _counters() == before


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_past_the_kernel_limits_matches_flash_ref(causal):
    (q, k, v), (qj, kj, vj) = _inputs([(1, 40, 4, 256), (1, 40, 2, 256), (1, 40, 2, 256)],
                                      "float32", seed=14)
    before = _counters()
    o = tops.mha_forward(q, k, v, causal=causal)
    _close(o, flash_ref(qj, kj, vj, causal=causal, chunk=16), _tol("float32"))
    _close(tfa.flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                               causal=causal).transpose(1, 2),
           flash_ref(qj, kj, vj, causal=causal), _tol("float32"))
    assert _counters() == before


def test_num_splits_rule():
    """Both routes split by num_splits_sm90: the serving shape gives 16 splits of
    2-3 tiles, one cluster of 16 CTAs a (batch, kv-head), 128 CTAs in all."""
    assert tfd.num_splits_sm90(520, 8) == 16
    tiles = -(-520 // tfd.TILE_SM90)
    assert {(s + 1) * tiles // 16 - s * tiles // 16 for s in range(16)} == {2, 3}
    assert tfd.num_splits_sm90(32768, 8) == 16          # 16 runs of 128 tiles
    assert tfd.num_splits_sm90(1, 8) == 1               # one row: one CTA, no cluster
    for clen in (1, 15, 17, 63, 64, 65, 300, 1000):
        n = tfd.num_splits_sm90(clen, 4)
        assert 1 <= n <= tfd.MAX_SPLIT_SM90
        assert n <= -(-clen // tfd.TILE_SM90)            # no split is empty


def test_launch_counters_do_not_move_on_cpu():
    (q, k, v), _ = _inputs([(1, 4, 8, 16), (1, 2, 8, 16), (1, 2, 8, 16)], "float32", 9)
    before = (tfa.launches, tfd.launches)
    tfa.flash_attention(q, k, v)
    tfd.flash_decode(q[:, :, 0], k, v, 5)
    assert (tfa.launches, tfd.launches) == before


@gpu
def test_cuda_kernels_match_plain_versions_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc; python3 chip_smoke.py runs the same check")
    (q, k, v), _ = _inputs([(1, 8, 100, 128), (1, 2, 100, 128), (1, 2, 100, 128)], "float32", 10)
    q, k, v = q.cuda(), k.cuda(), v.cuda()
    n0, f0 = tfa.launches, tfa.launches_f32
    o = tfa.flash_attention(q, k, v, causal=True)
    assert (tfa.launches, tfa.launches_f32) == (n0 + 1, f0 + 1)
    torch.testing.assert_close(o, tfa.flash_attention_plain(q, k, v, causal=True),
                               atol=2e-5, rtol=2e-5)
    # the fp32 kernel's row-tile pairing, ragged rows, L != S and D 112 / 16, in the
    # model-side layout (strided views)
    for B, H, Hkv, L, S, D, causal in [(2, 4, 2, 300, 300, 128, True),
                                       (1, 4, 1, 80, 80, 112, True),
                                       (1, 4, 1, 64, 384, 128, False),
                                       (1, 2, 2, 192, 192, 112, False),
                                       (1, 4, 2, 12, 12, 16, True)]:
        (q32, k32, v32), _ = _inputs([(B, L, H, D), (B, S, Hkv, D), (B, S, Hkv, D)],
                                     "float32", 11)
        q32, k32, v32 = q32.cuda(), k32.cuda(), v32.cuda()
        n0, f0 = tfa.launches, tfa.launches_f32
        o32 = tops.mha_forward(q32, k32, v32, causal=causal)
        assert (tfa.launches, tfa.launches_f32) == (n0 + 1, f0 + 1)
        torch.testing.assert_close(
            o32, tops.mha_forward(q32, k32, v32, causal=causal, mode="reference"),
            atol=2e-5, rtol=2e-5)
    # an fp32 view 4 bytes off a 16-byte boundary: the copies cannot address it
    flat = torch.zeros(1 + q.numel(), device="cuda")
    counters = (tfa.launches, tfa.launches_f32, tfa.launches_sm90)
    with pytest.raises(ValueError, match="16-byte"):
        tfa.flash_attention(flat[1:].view(q.shape), k, v, causal=True)
    assert (tfa.launches, tfa.launches_f32, tfa.launches_sm90) == counters
    # bf16 goes through the TMA + wgmma kernel; P is rounded to bf16 there
    qb, kb, vb = q.bfloat16(), k.bfloat16(), v.bfloat16()
    n0, s0 = tfa.launches, tfa.launches_sm90
    ob = tfa.flash_attention(qb, kb, vb, causal=True)
    assert (tfa.launches, tfa.launches_sm90) == (n0 + 1, s0 + 1)
    torch.testing.assert_close(ob, tfa.flash_attention_plain(qb, kb, vb, causal=True),
                               atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(ob, tfa.flash_attention_plain(qb, kb, vb, causal=True,
                                                             pv_bf16=True),
                               atol=2e-2, rtol=2e-2)
    flat = torch.zeros(1 + qb.numel(), dtype=torch.bfloat16, device="cuda")
    with pytest.raises(ValueError, match="TMA"):
        tfa.flash_attention(flat[1:].view(qb.shape), kb, vb, causal=True)
    n0, f0 = tfd.launches, tfd.launches_f32
    od = tfd.flash_decode(q[:, :, 0], k, v, 77)
    assert (tfd.launches, tfd.launches_f32) == (n0 + 1, f0 + 1)
    torch.testing.assert_close(od, tfd.flash_decode_plain(q[:, :, 0], k, v, 77),
                               atol=2e-5, rtol=2e-5)
    # the fp32 decode kernel, one launch with its cluster merge: G 16, head_dim 112,
    # one cached row, the partials
    for B, H, Hkv, S, D, clen in [(2, 32, 2, 512, 128, 333), (1, 8, 2, 384, 112, 200),
                                  (4, 16, 2, 1024, 128, 1)]:
        (q32, k32, v32), _ = _inputs([(B, H, D), (B, Hkv, S, D), (B, Hkv, S, D)],
                                     "float32", 15)
        q32, k32, v32 = q32.cuda(), k32.cuda(), v32.cuda()
        n0, f0 = tfd.launches, tfd.launches_f32
        od32 = tfd.flash_decode(q32, k32, v32, clen)
        acc, m, l = tfd.flash_decode(q32, k32, v32, clen, return_partials=True)
        assert (tfd.launches, tfd.launches_f32) == (n0 + 2, f0 + 2)
        torch.testing.assert_close(od32, tfd.flash_decode_plain(q32, k32, v32, clen),
                                   atol=2e-5, rtol=2e-5)
        acc_w, m_w, l_w = tfd.flash_decode_plain(q32, k32, v32, clen, return_partials=True)
        torch.testing.assert_close(m, m_w, atol=2e-5, rtol=2e-5)
        torch.testing.assert_close(l, l_w, atol=2e-5, rtol=2e-5)
        torch.testing.assert_close(acc / l[..., None], acc_w / l_w[..., None],
                                   atol=2e-5, rtol=2e-5)
    # an fp32 cache 4 bytes off a 16-byte boundary: the copies cannot read it
    flat = torch.zeros(1 + k.numel(), device="cuda")
    counters = (tfd.launches, tfd.launches_f32, tfd.launches_sm90)
    with pytest.raises(ValueError, match="16-byte"):
        tfd.flash_decode(q[:, :, 0], flat[1:].view(k.shape), v, 77)
    assert (tfd.launches, tfd.launches_f32, tfd.launches_sm90) == counters
    # bf16 decode goes through the sm90 kernel (cp.async ring, mma.sync, cluster merge)
    n0, s0 = tfd.launches, tfd.launches_sm90
    odb = tfd.flash_decode(qb[:, :, 0], kb, vb, 77)
    assert (tfd.launches, tfd.launches_sm90) == (n0 + 1, s0 + 1)
    torch.testing.assert_close(odb, tfd.flash_decode_plain(qb[:, :, 0], kb, vb, 77),
                               atol=2e-2, rtol=2e-2)
    flat = torch.zeros(1 + kb.numel(), dtype=torch.bfloat16, device="cuda")
    with pytest.raises(ValueError, match="TMA"):
        tfd.flash_decode(qb[:, :, 0], flat[1:].view(kb.shape), vb, 77)
    assert tfd.launches == n0 + 1

