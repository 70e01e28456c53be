"""Flash-decode: wrapper of the hand-written split-KV Hopper kernels.

Replaces the Pallas TPU kernel ``src/repro/kernels/flash_decode.py``
(``_decode_kernel`` / ``flash_decode``). The kernels are
``csrc/flash_decode.cu``. The work is bound by bytes: every K and V row below
``cache_len`` is read once and little is computed on it. ``B * Hkv`` blocks
(8 when serving) would leave most of the card's 132 SMs idle, so the KV axis is
split over blocks that each emit an fp32 ``(acc, m, l)`` partial, and a second
small kernel merges the splits by log-sum-exp. Only ``[0, cache_len)`` is read,
never the rest of ``S_max``.

The public layout is the TPU kernel's, q ``(B, H, D)`` and caches
``(B, Hkv, S, D)``, but the caches may be strided views (only D has to be
contiguous): ``ops.decode_forward`` passes transposed views of one layer's
``(B, S_max, Hkv, D)`` cache slice and nothing is copied. ``cache_len`` is one
host ``int`` for the whole batch.

A CUDA tensor launches the kernels or raises; a CPU tensor takes
``flash_decode_plain``. ``launches`` counts wrapper calls that launched.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
MAX_SPLIT = 64          # csrc/flash_decode.cu: MAX_SPLIT
MIN_ROWS_PER_SPLIT = 64
TARGET_BLOCKS = 264     # two blocks for each of the 132 SMs
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

launches = 0            # number of ``flash_decode`` calls that launched the kernels
_fn = None


def flash_decode_plain(q, k_cache, v_cache, cache_len: int, *,
                       return_partials: bool = False):
    """Plain PyTorch version of the kernels: same arithmetic, same layout."""
    B, H, D = q.shape
    Hkv, S = k_cache.shape[1], k_cache.shape[2]
    G = H // Hkv
    clen = _clamp_len(cache_len, S)
    qg = q.reshape(B, Hkv, G, D).float()
    s = torch.einsum("bhgd,bhsd->bhgs", qg, k_cache[:, :, :clen].float())
    s = s * (1.0 / math.sqrt(D))
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    acc = torch.einsum("bhgs,bhsd->bhgd", p, v_cache[:, :, :clen].float())
    if return_partials:
        return acc.reshape(B, H, D), m.reshape(B, H), l.reshape(B, H)
    o = acc / torch.clamp(l, min=1e-30)[..., None]
    return o.reshape(B, H, D).to(q.dtype)


def _clamp_len(cache_len, S: int) -> int:
    clen = min(int(cache_len), S)
    if clen < 1:
        raise ValueError(f"cache_len must be at least 1, got {cache_len}")
    return clen


def num_splits(clen: int, n_groups: int) -> int:
    """How many blocks share one (batch, kv-head)'s ``[0, clen)``.

    At least ``MIN_ROWS_PER_SPLIT`` rows a split, no more splits than fill the
    card about twice over, never more than the merge kernel's ``MAX_SPLIT``.
    """
    by_rows = -(-clen // MIN_ROWS_PER_SPLIT)
    by_card = max(1, -(-TARGET_BLOCKS // max(n_groups, 1)))
    n = max(1, min(by_rows, by_card, MAX_SPLIT))
    chunk = -(-clen // n)
    return -(-clen // chunk)        # drop splits that would be empty


def _entry():
    global _fn
    if _fn is None:
        fn = _build.load("flash_decode").repro_flash_decode
        p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        fn.argtypes = ([p] * 10 + [i] + [i] * 6 + [i64] * 8
                       + [ctypes.c_float, i, p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(q, k_cache, v_cache):
    if q.dim() != 3 or k_cache.dim() != 4 or v_cache.dim() != 4:
        raise ValueError("flash_decode takes q (B,H,D) and caches (B,Hkv,S,D)")
    B, H, D = q.shape
    if (k_cache.shape != v_cache.shape or k_cache.shape[0] != B
            or k_cache.shape[3] != D):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)} k {tuple(k_cache.shape)} "
                         f"v {tuple(v_cache.shape)}")
    Hkv = k_cache.shape[1]
    if H % Hkv != 0:
        raise ValueError(f"{H} query heads do not group over {Hkv} KV heads")
    if (q.dtype not in _DTYPE_CODE or k_cache.dtype != q.dtype
            or v_cache.dtype != q.dtype):
        raise TypeError(f"flash_decode kernel takes float32 or bfloat16, all alike; "
                        f"got {q.dtype}, {k_cache.dtype}, {v_cache.dtype}")
    if D > 128:
        raise ValueError(f"flash_decode kernel supports head_dim <= 128, got {D}")
    if H // Hkv > 16:
        raise ValueError(f"flash_decode kernel supports up to 16 query heads per "
                         f"KV head, got {H // Hkv}")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: the head dim must be contiguous")
        if t.device != q.device:
            raise ValueError("q and the caches must lie on one device")


def flash_decode(q, k_cache, v_cache, cache_len: int, *,
                 return_partials: bool = False):
    """q: (B, H, D); caches: (B, Hkv, S, D); cache_len: one host int.

    Returns (B, H, D) in q's type, or the unnormalised fp32 ``acc`` (B, H, D)
    with ``m`` and ``l`` (B, H) when ``return_partials`` (for a merge across
    sequence shards).
    """
    global launches
    _check(q, k_cache, v_cache)
    if q.device.type == "cpu":
        return flash_decode_plain(q, k_cache, v_cache, cache_len,
                                  return_partials=return_partials)
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_decode has no kernel for {q.device}")
    B, H, D = q.shape
    Hkv, S = k_cache.shape[1], k_cache.shape[2]
    G = H // Hkv
    clen = _clamp_len(cache_len, S)
    n_split = num_splits(clen, B * Hkv)
    # scratch and outputs come from PyTorch's allocator, which hands a freed
    # block only to later work on the same stream: the partials may be dropped
    # when this function returns although the kernels may not have run yet
    f32 = dict(dtype=torch.float32, device=q.device)
    part_acc = torch.empty((B, Hkv, n_split, G, D), **f32)
    part_ml = torch.empty((2, B, Hkv, n_split, G), **f32)
    if return_partials:
        out = None
        acc = torch.empty((B, H, D), **f32)
        ml = torch.empty((2, B, H), **f32)
        ptrs = (0, acc.data_ptr(), ml[0].data_ptr(), ml[1].data_ptr())
    else:
        out = torch.empty((B, H, D), dtype=q.dtype, device=q.device)
        ptrs = (out.data_ptr(), 0, 0, 0)
    with _build.on_device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _entry()(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                       part_acc.data_ptr(), part_ml[0].data_ptr(),
                       part_ml[1].data_ptr(), *ptrs, _DTYPE_CODE[q.dtype],
                       B, H, Hkv, D, clen, n_split,
                       q.stride(0), q.stride(1),
                       k_cache.stride(0), k_cache.stride(1), k_cache.stride(2),
                       v_cache.stride(0), v_cache.stride(1), v_cache.stride(2),
                       1.0 / math.sqrt(D), int(return_partials), stream)
    _build.check(err, "flash_decode")
    launches += 1
    if return_partials:
        return acc, ml[0], ml[1]
    return out
