"""The bf16 route of the port's FlashAttention forward, on the CPU.

The bf16 kernel (``csrc/flash_fwd_sm90.cu``) rounds P to bf16 before P·V, as
FA3 does; its plain version with ``pv_bf16=True`` repeats that arithmetic, and
is held here against the JAX package's ``flash_ref(pv_bf16=True)`` (the same
rounding) and against the Pallas kernel in interpret mode (P kept fp32), over
the grid of ``tests/test_kernels.py`` at the bf16 tolerance 2e-2. The kernel
itself is compared with this plain version on the card by ``chip_smoke.py``.
What decides the route (the dtype, and whether TMA can address a tensor in
place) is plain Python and is tested here.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as pallas_fwd
from repro.models.attention import flash_ref as jax_flash_ref
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import flash_decode as tfd
from repro_torch.kernels import ops as tops

BF16_TOL = dict(atol=2e-2, rtol=2e-2)

FWD_GRID = [
    (2, 4, 2, 128, 128, 64),
    (1, 8, 2, 256, 256, 128),
    (2, 4, 4, 100, 100, 64),      # non-multiple of block
    (1, 4, 1, 64, 384, 128),      # cross (L != S)
    (1, 2, 2, 192, 192, 112),     # head_dim 112
]
CASES = [(shape, causal) for shape in FWD_GRID for causal in (True, False)
         if not (causal and shape[3] != shape[4])]     # the kernels' causal mask needs L == S


def _bf16_inputs(B, H, Hkv, L, S, D, seed):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s, dtype=np.float32)
            for s in ((B, H, L, D), (B, Hkv, S, D), (B, Hkv, S, D))]
    return ([torch.from_numpy(a).bfloat16() for a in arrs],
            [jnp.asarray(a).astype(jnp.bfloat16) for a in arrs])


def _close(t, j, tol):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32), **tol)


@pytest.mark.parametrize("shape,causal", CASES)
def test_plain_pv_bf16_matches_flash_ref_pv_bf16_and_pallas(shape, causal):
    (q, k, v), (qj, kj, vj) = _bf16_inputs(*shape, seed=20)
    o = tfa.flash_attention_plain(q, k, v, causal=causal, pv_bf16=True)
    assert o.dtype == torch.bfloat16 and o.shape == q.shape
    # flash_ref works in the model-side layout (B, L, H, D)
    ref = jax_flash_ref(qj.transpose(0, 2, 1, 3), kj.transpose(0, 2, 1, 3),
                        vj.transpose(0, 2, 1, 3), causal=causal, pv_bf16=True)
    _close(o, ref.transpose(0, 2, 1, 3), BF16_TOL)
    _close(o, pallas_fwd(qj, kj, vj, causal=causal, block_q=64, block_k=64, interpret=True),
           BF16_TOL)


def test_pv_bf16_is_off_by_default_and_changes_only_the_rounding():
    (q, k, v), _ = _bf16_inputs(1, 4, 2, 128, 128, 64, seed=21)
    fp32_p = tfa.flash_attention_plain(q, k, v, causal=True)
    assert torch.equal(fp32_p, tfa.flash_attention_plain(q, k, v, causal=True, pv_bf16=False))
    bf16_p = tfa.flash_attention_plain(q, k, v, causal=True, pv_bf16=True)
    np.testing.assert_allclose(bf16_p.float().numpy(), fp32_p.float().numpy(), **BF16_TOL)
    # in fp32 the rounding is visible above fp32 noise
    qf, kf, vf = q.float(), k.float(), v.float()
    diff = (tfa.flash_attention_plain(qf, kf, vf, pv_bf16=True)
            - tfa.flash_attention_plain(qf, kf, vf)).abs().max()
    assert 1e-5 < float(diff) < 2e-2


@pytest.mark.parametrize("L,H,Hkv,D", [(512, 16, 2, 128), (12, 4, 2, 16), (100, 4, 4, 64),
                                       (192, 2, 2, 112)])
def test_tma_accepts_the_model_side_views(L, H, Hkv, D):
    """ops.mha_forward hands the kernel transposed views of (B, L, H, D) tensors."""
    for heads in (H, Hkv):
        t = torch.zeros(2, L, heads, D, dtype=torch.bfloat16)
        assert tfa._tma_addressable(t.transpose(1, 2))
        assert tfa._tma_addressable(t)


def test_tma_refuses_what_it_cannot_address():
    flat = torch.zeros(1 + 4 * 64 * 64, dtype=torch.bfloat16)
    assert tfa._tma_addressable(flat[:-1].view(1, 4, 64, 64))
    assert not tfa._tma_addressable(flat[1:].view(1, 4, 64, 64))    # base 2 bytes off
    odd = torch.zeros(1, 4, 8, 20, dtype=torch.bfloat16)             # rows 40 bytes apart
    assert not tfa._tma_addressable(odd)
    assert not tfa._tma_addressable(odd.transpose(2, 3))             # last dim not contiguous
    wide = torch.zeros(1, 4, 8, 24, dtype=torch.bfloat16)            # rows 48 bytes apart
    assert tfa._tma_addressable(wide)
    assert not tfa._tma_addressable(wide[:, :, :, 1:])               # base and rows misaligned
    # an axis of extent 1 is never stepped along: its stride does not matter
    assert tfa._tma_addressable(torch.zeros(1, 1, 1, 20, dtype=torch.bfloat16))


def test_cpu_bf16_takes_the_plain_version_and_moves_no_counter():
    (q, k, v), _ = _bf16_inputs(1, 4, 2, 64, 64, 64, seed=22)
    counters = lambda: (tfa.launches, tfa.launches_sm90, tfa.launches_f32, tfd.launches)  # noqa: E731
    before = counters()
    o = tfa.flash_attention(q, k, v, causal=True)
    assert torch.equal(o, tfa.flash_attention_plain(q, k, v, causal=True))
    # a view TMA could not address is no reason to refuse a CPU tensor
    flat = torch.zeros(1 + q.numel(), dtype=torch.bfloat16)
    flat[1:] = q.reshape(-1)
    assert torch.equal(tfa.flash_attention(flat[1:].view(q.shape), k, v, causal=True), o)
    tops.mha_forward(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), causal=True)
    assert counters() == before


def test_launch_counter_is_the_sum_of_the_routes():
    assert tfa.launches == tfa.launches_sm90 + tfa.launches_f32
