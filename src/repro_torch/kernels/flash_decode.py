"""Flash-decode: wrapper of the hand-written split-KV Hopper kernels.

Replaces the Pallas TPU kernel ``src/repro/kernels/flash_decode.py``
(``_decode_kernel`` / ``flash_decode``). The work is bound by bytes: every K
and V row below ``cache_len`` is read once and little is computed on it.
``B * Hkv`` blocks (8 when serving) would leave most of the card's 132 SMs
idle, so the KV axis is split over blocks that each emit an fp32
``(acc, m, l)`` partial, merged by log-sum-exp inside the same launch. Only
``[0, cache_len)`` is read, never the rest of ``S_max``. A CUDA tensor is
routed by dtype:

- bf16 goes to ``csrc/flash_decode_sm90.cu``: 16-byte asynchronous copies
  (``cp.async``) of 16-row tiles into an mbarrier-guarded ring, both products
  on the tensor cores (P kept to 16 significant bits as ``P_hi + P_lo``), and
  the merge in the same launch: the splits of one (batch, kv-head) form a
  thread-block cluster and merge through distributed shared memory, so no
  scratch is needed. Splits by ``num_splits_sm90``. The copies read the
  caches in place, 16 bytes at a time, so a bf16 cache that breaks TMA's
  16-byte rule, or a head dim that is not a multiple of 8, raises
  ``ValueError``: nothing falls back.
- fp32 goes to ``csrc/flash_decode.cu``: the same ring, split rule and
  cluster merge, with both products as fp32 FMAs (TF32 would not agree with
  fp32 to 2e-5): a lane holds four head dims of q and of the output for all
  the group's heads, so each float read from shared memory feeds G FMAs, and
  the partial dots are summed across lanes by shuffles. It agrees with fp32
  to 2e-5. Its copies read 16-byte chunks too, so an fp32 cache they cannot
  address, or a head dim that is not a multiple of 4, raises ``ValueError``.

Both kernels take head_dim <= 128 and at most 16 query heads a KV head; a
CUDA tensor past that raises ``ValueError`` before any launch, while a CPU
tensor of any size takes the plain version, as the JAX package does.

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
TARGET_BLOCKS = 264     # two blocks for each of the 132 SMs
TILE_SM90 = 16          # csrc/flash_decode{,_sm90}.cu: TN, rows of a tile
MAX_SPLIT_SM90 = 16     # csrc/flash_decode{,_sm90}.cu: MAX_SPLIT, the CTAs of a cluster
MIN_TILES_PER_SPLIT = 2
_DTYPES = (torch.float32, torch.bfloat16)
_ARGS = struct.Struct("<19q")   # csrc/flash_decode{,_sm90}.cu: struct DecodeArgs

launches = 0            # kernel launches made by ``flash_decode``, both routes
launches_sm90 = 0       # of which bf16, csrc/flash_decode_sm90.cu
launches_f32 = 0        # of which fp32, csrc/flash_decode.cu
_fns: dict = {}         # source name -> its C entry point


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


@functools.lru_cache(maxsize=4096)
def num_splits_sm90(clen: int, n_groups: int) -> int:
    """How many blocks of either kernel share one (batch, kv-head)'s ``[0, clen)``.

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


def _entry(name: str):
    """The C entry point of ``csrc/<name>.cu``; it takes one packed ``_ARGS``."""
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(_build.load(name), f"repro_{name}")
        fn.argtypes = [ctypes.c_char_p]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


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
    if dt not in _DTYPES or k_cache.dtype != dt or v_cache.dtype != dt:
        raise TypeError(f"flash_decode kernel takes float32 or bfloat16, all alike; "
                        f"got {dt}, {k_cache.dtype}, {v_cache.dtype}")
    if q.stride(-1) != 1 or k_cache.stride(-1) != 1 or v_cache.stride(-1) != 1:
        raise ValueError("q, k_cache and v_cache: the head dim must be contiguous")
    dev = q.device
    if k_cache.device != dev or v_cache.device != dev:
        raise ValueError("q and the caches must lie on one device")


def _check_limits(D: int, G: int) -> None:
    """The kernels' own limits; the plain version takes any size."""
    if D > 128:
        raise ValueError(f"flash_decode kernel supports head_dim <= 128, got {D}")
    if G > 16:
        raise ValueError(f"flash_decode kernel supports up to 16 query heads per "
                         f"KV head, got {G}")


def _launch_sm90(q, k_cache, v_cache, clen, return_partials, stream):
    return _launch("flash_decode_sm90", "bf16", q, k_cache, v_cache, clen,
                   return_partials, stream)


def _launch_f32(q, k_cache, v_cache, clen, return_partials, stream):
    return _launch("flash_decode", "fp32", q, k_cache, v_cache, clen,
                   return_partials, stream)


def _launch(name, kind, q, k_cache, v_cache, clen, return_partials, stream):
    """Checks what the kernel of ``csrc/<name>.cu`` takes, then launches it once."""
    B, H, D = q.shape
    Hkv = k_cache.shape[1]
    _check_limits(D, H // Hkv)
    per_chunk = 16 // q.element_size()
    if D % per_chunk:
        raise ValueError(f"the {kind} decode kernel copies rows in 16-byte chunks: head_dim "
                         f"must be a multiple of {per_chunk}, got {D}")
    for what, t in (("k_cache", k_cache), ("v_cache", v_cache)):
        if not _build.tma_addressable(t):
            raise ValueError(f"{what}: the {kind} decode kernel copies the cache in 16-byte "
                             "chunks, which needs a 16-byte aligned base and strides that "
                             "are multiples of 16 bytes (TMA's rule); got strides "
                             f"{t.stride()} at {t.data_ptr():#x}")
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
    err = _entry(name)(_ARGS.pack(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), *outs, stream,
        B, H, Hkv, D, clen, n_split, ks[0], ks[1], ks[2], vs[0], vs[1], vs[2]))
    _build.check(err, name)
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
