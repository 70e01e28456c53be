"""Flash-decode: wrapper of the hand-written split-KV Hopper kernels.

Replaces the Pallas TPU kernel ``src/repro/kernels/flash_decode.py``
(``_decode_kernel`` / ``flash_decode``). The work is bound by bytes: every K
and V row below ``cache_len`` is read once and little is computed on it.
``B * Hkv`` blocks (8 when serving) would leave most of the card's 132 SMs
idle, so the KV axis is split over blocks that each emit an fp32
``(acc, m, l)`` partial, merged by log-sum-exp. Only ``[0, cache_len)`` is
read, never the rest of ``S_max``. A CUDA tensor is routed by dtype:

- bf16 goes to ``csrc/flash_decode_sm90.cu``: 16-byte asynchronous copies
  (``cp.async``) of 16-row tiles into an mbarrier-guarded ring, both products
  on the tensor cores (P kept to 16 significant bits as ``P_hi + P_lo``), and
  the merge in the same launch: the splits of one (batch, kv-head) form a
  thread-block cluster and merge through distributed shared memory, so no
  scratch is needed. Splits by ``num_splits_sm90``. The copies read the
  caches in place, 16 bytes at a time, so a bf16 cache that breaks TMA's
  16-byte rule, or a head dim that is not a multiple of 8, raises
  ``ValueError``: nothing falls back.
- fp32 goes to ``csrc/flash_decode.cu``: fp32 FMAs, a split kernel and a merge
  kernel, splits by ``num_splits``; it agrees with fp32 to 2e-5.

The public layout is the TPU kernel's, q ``(B, H, D)`` and caches
``(B, Hkv, S, D)``, but the caches may be strided views (only D has to be
contiguous): ``ops.decode_forward`` passes transposed views of one layer's
``(B, S_max, Hkv, D)`` cache slice and nothing is copied. ``cache_len`` is one
host ``int`` for the whole batch.

A CPU tensor takes ``flash_decode_plain``. ``launches_sm90`` and
``launches_f32`` count the launches of each route, ``launches`` their sum;
nothing else moves them.
"""
from __future__ import annotations

import ctypes
import functools
import math
import struct

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
MAX_SPLIT = 64          # csrc/flash_decode.cu: MAX_SPLIT
MIN_ROWS_PER_SPLIT = 64
TARGET_BLOCKS = 264     # two blocks for each of the 132 SMs
TILE_SM90 = 16          # csrc/flash_decode_sm90.cu: TN, rows of a tile
MAX_SPLIT_SM90 = 16     # csrc/flash_decode_sm90.cu: MAX_SPLIT, the CTAs of a cluster
MIN_TILES_PER_SPLIT = 2
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ARGS_SM90 = struct.Struct("<19q")   # csrc/flash_decode_sm90.cu: struct DecodeArgs

launches = 0            # kernel launches made by ``flash_decode``, both routes
launches_sm90 = 0       # of which bf16, csrc/flash_decode_sm90.cu
launches_f32 = 0        # of which fp32, csrc/flash_decode.cu
_fn = None
_fn_sm90 = None
# (device index, stream) -> fp32 partials of the fp32 route; see _workspace
_work: dict = {}


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


@functools.lru_cache(maxsize=4096)
def num_splits_sm90(clen: int, n_groups: int) -> int:
    """How many blocks of the bf16 kernel share one (batch, kv-head)'s ``[0, clen)``.

    The kernel cuts the ``ceil(clen / TILE_SM90)`` tiles into this many
    balanced runs (``split * tiles // n`` onwards), so none is empty. At least
    ``MIN_TILES_PER_SPLIT`` tiles a split on average, no more splits than fill
    the card about twice over (``TARGET_BLOCKS``), and never more than one
    cluster holds (``MAX_SPLIT_SM90``), since the splits merge inside their
    cluster. Serving (``clen`` 520, 8 groups): 16 splits of 2-3 tiles, 128
    blocks on the 132 SMs; a 32k cache: 16 splits of 128 tiles.
    """
    tiles = -(-clen // TILE_SM90)
    by_rows = -(-tiles // MIN_TILES_PER_SPLIT)
    by_card = max(1, -(-TARGET_BLOCKS // max(n_groups, 1)))
    return max(1, min(by_rows, by_card, MAX_SPLIT_SM90))


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


def _entry_sm90():
    global _fn_sm90
    if _fn_sm90 is None:
        fn = _build.load("flash_decode_sm90").repro_flash_decode_sm90
        fn.argtypes = [ctypes.c_char_p]      # the packed _ARGS_SM90
        fn.restype = ctypes.c_int
        _fn_sm90 = fn
    return _fn_sm90


def _workspace(device, stream: int, n: int):
    """fp32 scratch of at least ``n`` floats for the fp32 route's partials.

    One buffer per (device, stream), grown when a call needs more and otherwise
    reused without allocation. That is safe under PyTorch's stream semantics:
    kernels on one stream run one after another, so a launch finds the
    partials of the previous launch on its stream no longer in use; a call on
    another stream gets a buffer of its own. A buffer replaced by a larger one
    goes back to PyTorch's allocator, which hands it only to later work on the
    same stream.
    """
    key = (device.index, stream)
    buf = _work.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.empty(max(n, buf.numel() if buf is not None else 0),
                          dtype=torch.float32, device=device)
        _work[key] = buf
    return buf


def _check(q, k_cache, v_cache):
    # written for the host's time: every decode step calls this once per layer
    qs, ks = q.shape, k_cache.shape
    if len(qs) != 3 or len(ks) != 4 or v_cache.dim() != 4:
        raise ValueError("flash_decode takes q (B,H,D) and caches (B,Hkv,S,D)")
    B, H, D = qs
    if ks != v_cache.shape or ks[0] != B or ks[3] != D:
        raise ValueError(f"shape mismatch: q {tuple(qs)} k {tuple(ks)} "
                         f"v {tuple(v_cache.shape)}")
    Hkv = ks[1]
    if H % Hkv != 0:
        raise ValueError(f"{H} query heads do not group over {Hkv} KV heads")
    dt = q.dtype
    if dt not in _DTYPE_CODE or k_cache.dtype != dt or v_cache.dtype != dt:
        raise TypeError(f"flash_decode kernel takes float32 or bfloat16, all alike; "
                        f"got {dt}, {k_cache.dtype}, {v_cache.dtype}")
    if D > 128:
        raise ValueError(f"flash_decode kernel supports head_dim <= 128, got {D}")
    if H // Hkv > 16:
        raise ValueError(f"flash_decode kernel supports up to 16 query heads per "
                         f"KV head, got {H // Hkv}")
    if q.stride(-1) != 1 or k_cache.stride(-1) != 1 or v_cache.stride(-1) != 1:
        raise ValueError("q, k_cache and v_cache: the head dim must be contiguous")
    dev = q.device
    if k_cache.device != dev or v_cache.device != dev:
        raise ValueError("q and the caches must lie on one device")


def _launch_sm90(q, k_cache, v_cache, clen, return_partials, stream):
    B, H, D = q.shape
    if D % 8:
        raise ValueError(f"the bf16 decode kernel copies rows in 16-byte chunks: head_dim "
                         f"must be a multiple of 8, got {D}")
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache)):
        if not _build.tma_addressable(t):
            raise ValueError(f"{name}: the bf16 decode kernel copies the cache in 16-byte "
                             "chunks, which needs a 16-byte aligned base and strides that "
                             "are multiples of 16 bytes (TMA's rule); got strides "
                             f"{t.stride()} at {t.data_ptr():#x}")
    Hkv = k_cache.shape[1]
    n_split = num_splits_sm90(clen, B * Hkv)
    if not q.is_contiguous() or q.data_ptr() % 16:
        q = q.clone(memory_format=torch.contiguous_format)
    if return_partials:
        acc = torch.empty((B, H, D), dtype=torch.float32, device=q.device)
        ml = torch.empty((2, B, H), dtype=torch.float32, device=q.device)
        res = (acc, ml[0], ml[1])
        outs = (acc.data_ptr(), ml[0].data_ptr(), ml[1].data_ptr())
    else:
        res = torch.empty_like(q)
        outs = (res.data_ptr(), 0, 0)
    ks, vs = k_cache.stride(), v_cache.stride()
    err = _entry_sm90()(_ARGS_SM90.pack(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), *outs, stream,
        B, H, Hkv, D, clen, n_split, ks[0], ks[1], ks[2], vs[0], vs[1], vs[2]))
    _build.check(err, "flash_decode_sm90")
    return res


def _launch_f32(q, k_cache, v_cache, clen, return_partials, stream):
    B, H, D = q.shape
    Hkv = k_cache.shape[1]
    G = H // Hkv
    n_split = num_splits(clen, B * Hkv)
    n_part = B * Hkv * n_split * G
    part = _workspace(q.device, stream, n_part * (D + 2))
    part_acc = part.data_ptr()
    part_m = part_acc + 4 * n_part * D
    part_l = part_m + 4 * n_part
    if return_partials:
        acc = torch.empty((B, H, D), dtype=torch.float32, device=q.device)
        ml = torch.empty((2, B, H), dtype=torch.float32, device=q.device)
        res = (acc, ml[0], ml[1])
        ptrs = (0, acc.data_ptr(), ml[0].data_ptr(), ml[1].data_ptr())
    else:
        res = torch.empty((B, H, D), dtype=q.dtype, device=q.device)
        ptrs = (res.data_ptr(), 0, 0, 0)
    err = _entry()(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                   part_acc, part_m, part_l, *ptrs, _DTYPE_CODE[q.dtype],
                   B, H, Hkv, D, clen, n_split,
                   q.stride(0), q.stride(1),
                   k_cache.stride(0), k_cache.stride(1), k_cache.stride(2),
                   v_cache.stride(0), v_cache.stride(1), v_cache.stride(2),
                   1.0 / math.sqrt(D), int(return_partials), stream)
    _build.check(err, "flash_decode")
    return res


def flash_decode(q, k_cache, v_cache, cache_len: int, *,
                 return_partials: bool = False):
    """q: (B, H, D); caches: (B, Hkv, S, D); cache_len: one host int.

    Returns (B, H, D) in q's type, or the unnormalised fp32 ``acc`` (B, H, D)
    with ``m`` and ``l`` (B, H) when ``return_partials`` (for a merge across
    sequence shards).
    """
    global launches, launches_sm90, launches_f32
    _check(q, k_cache, v_cache)
    if q.device.type == "cpu":
        return flash_decode_plain(q, k_cache, v_cache, cache_len,
                                  return_partials=return_partials)
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_decode has no kernel for {q.device}")
    clen = _clamp_len(cache_len, k_cache.shape[2])
    sm90 = q.dtype == torch.bfloat16
    with _build.on_device(q.device):
        # the raw handle of the current stream, without a Stream object
        stream = torch._C._cuda_getCurrentRawStream(q.device.index)
        launch = _launch_sm90 if sm90 else _launch_f32
        res = launch(q, k_cache, v_cache, clen, return_partials, stream)
    if sm90:
        launches_sm90 += 1
    else:
        launches_f32 += 1
    launches += 1
    return res
