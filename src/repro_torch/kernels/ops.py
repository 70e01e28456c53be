"""Public attention entry points in the model-side layout.

``mode`` is ``None`` (dispatch on where the tensor lies: a CUDA tensor goes to
the hand-written kernel, a CPU tensor to the kernel's plain version) or
``"reference"`` (force the plain version; for tests and for comparing the
kernels with their plain versions on the card).

The transposes below are views: the kernels take strides, so nothing is copied.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import flash_decode as _fd


def _check_mode(mode):
    if mode not in (None, "reference"):
        raise ValueError(f"mode must be None or 'reference', got {mode!r}")


def mha_forward(q, k, v, *, causal: bool = True, mode: Optional[str] = None):
    """Layout: q (B, L, H, D); k/v (B, S, Hkv, D) — model-side layout."""
    _check_mode(mode)
    if causal and q.shape[1] != k.shape[1]:
        # the kernel's causal mask has no query offset
        raise ValueError("causal mha_forward needs L == S, got "
                         f"L={q.shape[1]}, S={k.shape[1]}")
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    if mode == "reference":
        o = _fa.flash_attention_plain(qt, kt, vt, causal=causal)
    else:
        o = _fa.flash_attention(qt, kt, vt, causal=causal)
    return o.transpose(1, 2)


def decode_forward(q, k_cache, v_cache, cache_len: int, *,
                   mode: Optional[str] = None, return_partials: bool = False):
    """Layout: q (B, 1, H, D); caches (B, S, Hkv, D) — model-side layout.

    ``cache_len`` is one host int. Returns (B, 1, H, D), or with
    ``return_partials`` the fp32 ``(acc (B,H,D), m (B,H), l (B,H))``.
    """
    _check_mode(mode)
    B, L, H, D = q.shape
    if L != 1:
        raise ValueError(f"decode_forward takes one query token, got L={L}")
    fn = _fd.flash_decode_plain if mode == "reference" else _fd.flash_decode
    out = fn(q.reshape(B, H, D), k_cache.transpose(1, 2), v_cache.transpose(1, 2),
             cache_len, return_partials=return_partials)
    if return_partials:
        return out
    return out.reshape(B, 1, H, D)
