"""The fp32 route of the port's FlashAttention forward, on the CPU.

The fp32 kernel (``csrc/flash_fwd.cu``) fills its K/V ring with 16-byte
``cp.async`` copies, so it needs tensors those copies can address, as TMA
does; the model-side views are, and a misaligned CUDA tensor is refused. A CPU
tensor takes the plain version whatever its alignment and moves no counter.
The plain version itself is held against the JAX package's Pallas kernel and
oracle, at the fp32 kernel's edge shapes too, in ``tests/test_torch_kernels.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops


def _inputs(B, H, Hkv, L, S, D, seed):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s, dtype=np.float32)
            for s in ((B, H, L, D), (B, Hkv, S, D), (B, Hkv, S, D))]
    return [torch.from_numpy(a) for a in arrs]


@pytest.mark.parametrize("D", [16, 64, 112, 128])
def test_fp32_model_side_views_are_addressable_by_the_copies(D):
    for heads in (16, 2):
        t = torch.zeros(2, 96, heads, D)
        assert tfa._tma_addressable(t.transpose(1, 2))
    flat = torch.zeros(1 + 4 * 64 * D)
    assert not tfa._tma_addressable(flat[1:].view(1, 4, 64, D))       # base 4 bytes off
    assert not tfa._tma_addressable(torch.zeros(1, 4, 8, 6))            # rows 24 bytes apart


def test_cpu_fp32_takes_the_plain_version_whatever_the_alignment():
    q, k, v = _inputs(1, 4, 2, 64, 64, 64, seed=31)
    before = (tfa.launches, tfa.launches_f32, tfa.launches_sm90)
    flat = torch.zeros(1 + q.numel())
    flat[1:] = q.reshape(-1)
    o = tfa.flash_attention(flat[1:].view(q.shape), k, v, causal=True)
    assert torch.equal(o, tfa.flash_attention_plain(q, k, v, causal=True))
    tops.mha_forward(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), causal=True)
    assert (tfa.launches, tfa.launches_f32, tfa.launches_sm90) == before
