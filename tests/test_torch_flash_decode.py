"""The bf16 route of the port's flash-decode, on the CPU.

The bf16 kernel (``csrc/flash_decode_sm90.cu``) keeps P to 16 significant bits
(``P_hi + P_lo``), so its plain version is ``flash_decode_plain`` as it stands,
with P in fp32 as in the TPU kernel. That plain version is held here, on bf16
inputs, against the Pallas kernel in interpret mode and against the JAX
package's ``flash_ref`` over the filled part of the cache, over the decode grid
of ``tests/test_kernels.py`` plus the serving group size, at the bf16
tolerance 2e-2 (the partials, which carry no rounding to bf16, at 2e-5). The
kernel itself is compared with this plain version on the card by
``chip_smoke.py``. What decides the route and the launch (the dtype, TMA's
addressability, the split rule, the packed argument block) is plain Python
and is tested here.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_decode import flash_decode as pallas_decode
from repro.models.attention import flash_ref as jax_flash_ref
from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import flash_decode as tfd
from repro_torch.kernels import ops as tops

BF16_TOL = dict(atol=2e-2, rtol=2e-2)
F32_TOL = dict(atol=2e-5, rtol=2e-5)

DECODE_GRID = [
    (2, 8, 2, 512, 64, 300),
    (1, 16, 8, 1024, 128, 1024),
    (2, 4, 4, 256, 64, 1),
    (1, 6, 1, 640, 128, 77),      # G=6, ragged length
    (2, 16, 2, 256, 128, 130),    # G=8, D=128: the serving group size and width
]


def _bf16_inputs(B, H, Hkv, S, D, seed):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s, dtype=np.float32)
            for s in ((B, H, D), (B, Hkv, S, D), (B, Hkv, S, D))]
    return ([torch.from_numpy(a).bfloat16() for a in arrs],
            [jnp.asarray(a).astype(jnp.bfloat16) for a in arrs])


def _close(t, j, tol):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32), **tol)


@pytest.mark.parametrize("B,H,Hkv,S,D,clen", DECODE_GRID)
@pytest.mark.parametrize("partials", [False, True])
def test_bf16_plain_matches_pallas_and_flash_ref(B, H, Hkv, S, D, clen, partials):
    (q, kc, vc), (qj, kcj, vcj) = _bf16_inputs(B, H, Hkv, S, D, seed=30)
    if partials:
        acc, m, l = tfd.flash_decode_plain(q, kc, vc, clen, return_partials=True)
        accj, mj, lj = pallas_decode(qj, kcj, vcj, clen, block_k=128,
                                     return_partials=True, interpret=True)
        assert acc.dtype == m.dtype == l.dtype == torch.float32
        _close(m, mj, F32_TOL)
        _close(l, lj, F32_TOL)
        _close(acc / l[..., None], accj / lj[..., None], F32_TOL)
        return
    o = tfd.flash_decode_plain(q, kc, vc, clen)
    assert o.dtype == torch.bfloat16 and o.shape == (B, H, D)
    _close(o, pallas_decode(qj, kcj, vcj, clen, block_k=128, interpret=True), BF16_TOL)
    # flash_ref in the model-side layout (B, S, Hkv, D) over the filled rows only
    ref = jax_flash_ref(qj[:, None], kcj[:, :, :clen].transpose(0, 2, 1, 3),
                        vcj[:, :, :clen].transpose(0, 2, 1, 3), causal=False)
    _close(o, ref[:, 0], BF16_TOL)


def _runs(n, tiles):
    """Tiles of each split, cut as csrc/flash_decode_sm90.cu cuts them."""
    return [(s + 1) * tiles // n - s * tiles // n for s in range(n)]


def test_split_rule_fills_the_card_at_the_serving_shape():
    n = tfd.num_splits_sm90(520, 8)                   # B 4 x Hkv 2, cache_len 520
    # the splits of a (batch, kv-head) are one cluster, at most 16 CTAs: 128
    # blocks for the 132 SMs
    assert n == tfd.MAX_SPLIT_SM90 == 16 and n * 8 == 128
    runs = _runs(n, -(-520 // tfd.TILE_SM90))
    assert 32 <= tfd.TILE_SM90 * min(runs) <= tfd.TILE_SM90 * max(runs) <= 64
    assert tfd.num_splits_sm90(32768, 8) == tfd.MAX_SPLIT_SM90   # 16 runs of 128 tiles
    assert tfd.num_splits_sm90(520, 64) * 64 >= 132               # more groups, fewer splits
    assert tfd.num_splits_sm90(1, 8) == 1
    assert tfd.num_splits_sm90(10 ** 6, 1) == tfd.MAX_SPLIT_SM90


@pytest.mark.parametrize("clen", [1, 15, 16, 17, 31, 32, 33, 100, 520, 1024, 4097, 32768])
@pytest.mark.parametrize("groups", [1, 4, 8, 64, 300])
def test_split_rule_has_no_empty_split_and_respects_the_cap(clen, groups):
    n = tfd.num_splits_sm90(clen, groups)
    tiles = -(-clen // tfd.TILE_SM90)
    runs = _runs(n, tiles)
    assert 1 <= n <= tfd.MAX_SPLIT_SM90
    assert min(runs) >= 1 and sum(runs) == tiles
    assert n <= -(-tiles // tfd.MIN_TILES_PER_SPLIT)
    assert n == 1 or n * groups <= 2 * tfd.TARGET_BLOCKS


@pytest.mark.parametrize("D", [16, 64, 112, 128])
def test_tma_accepts_the_model_side_cache_views(D):
    """ops.decode_forward hands the kernel transposed views of (B, S_max, Hkv, D)."""
    cache = torch.zeros(4, 1024, 2, D, dtype=torch.bfloat16)
    assert _build.tma_addressable(cache.transpose(1, 2))
    assert _build.tma_addressable(cache[1].unsqueeze(0).transpose(1, 2))


def test_tma_check_is_shared_by_both_wrappers():
    assert tfa._tma_addressable is _build.tma_addressable
    flat = torch.zeros(1 + 2 * 64 * 64, dtype=torch.bfloat16)
    assert not _build.tma_addressable(flat[1:].view(1, 2, 64, 64))  # base 2 bytes off


def test_cpu_bf16_takes_the_plain_version_and_moves_no_counter():
    (q, kc, vc), _ = _bf16_inputs(2, 8, 2, 128, 64, seed=31)
    counters = lambda: (tfd.launches, tfd.launches_sm90, tfd.launches_f32)  # noqa: E731
    before = counters()
    o = tfd.flash_decode(q, kc, vc, 100)
    assert torch.equal(o, tfd.flash_decode_plain(q, kc, vc, 100))
    # a cache view TMA could not address is no reason to refuse a CPU tensor
    flat = torch.zeros(1 + kc.numel(), dtype=torch.bfloat16)
    flat[1:] = kc.reshape(-1)
    assert torch.equal(tfd.flash_decode(q, flat[1:].view(kc.shape), vc, 100), o)
    tops.decode_forward(q[:, None], kc.transpose(1, 2), vc.transpose(1, 2), 100)
    with pytest.raises(ValueError, match="cache_len"):
        tfd.flash_decode(q, kc, vc, 0)
    assert counters() == before
    assert tfd.launches == tfd.launches_sm90 + tfd.launches_f32


def test_bf16_launch_refuses_what_the_copies_cannot_read_before_any_launch():
    """The kernel copies whole 16-byte cache rows; the checks come before the library."""
    (q, kc, vc), _ = _bf16_inputs(1, 4, 2, 64, 64, seed=32)
    before = (tfd.launches, tfd.launches_sm90, tfd.launches_f32)
    flat = torch.zeros(1 + kc.numel(), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="TMA"):
        tfd._launch_sm90(q, flat[1:].view(kc.shape), vc, 40, False, 0)
    narrow = torch.zeros(1, 2, 64, 12, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 8"):
        tfd._launch_sm90(torch.zeros(1, 4, 12, dtype=torch.bfloat16), narrow, narrow, 40,
                         False, 0)
    assert (tfd.launches, tfd.launches_sm90, tfd.launches_f32) == before


def test_bf16_call_packs_one_argument_block():
    assert tfd._ARGS.size == 19 * 8                    # csrc: struct DecodeArgs, both kernels
