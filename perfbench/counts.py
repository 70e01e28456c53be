"""Operations and bytes of each kernel and of each step, worked out from shapes.

Every count is what the inputs need, not what a kernel happens to do: each
input byte read once and each output byte written once, a causal attention's
products over the pairs its mask keeps, a decode's over the ``cache_len``
filled rows (not ``max_seq``). Model FLOPs count a multiply-add as two and
leave recomputation out. ``roofline_s`` is the least time the card could
take: the larger of operations over the peak rate and bytes over the memory
bandwidth (``peaks.json``).
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional, Tuple

from perfbench import bench

PEAKS = Path(__file__).resolve().parent / "peaks.json"


def peaks(kind: str) -> Optional[Dict[str, float]]:
    """The data sheet's peaks of the card named ``kind``, or None."""
    return bench.load_json(PEAKS)["devices"].get(kind)


def roofline_s(flops: float, nbytes: float, pk: Dict[str, float], rate: str = "bf16_flop_s") -> float:
    return max(flops / pk[rate], nbytes / pk["hbm_byte_s"])


def causal_pairs(L: int) -> int:
    """(query, key) pairs a causal mask keeps in an L x L attention."""
    return L * (L + 1) // 2


def flash_fwd(B: int, H: int, Hkv: int, L: int, S: int, D: int, causal: bool,
              elt: int = 2) -> Tuple[int, int]:
    """(FLOPs, bytes) of one attention forward: Q·Kᵀ and P·V over the kept
    pairs; q, k, v read and o written once."""
    pairs = causal_pairs(L) if causal else L * S
    flops = 4 * B * H * D * pairs
    nbytes = elt * (2 * B * H * L * D + 2 * B * Hkv * S * D)
    return flops, nbytes


def flash_decode(B: int, H: int, Hkv: int, D: int, clen: int, elt: int = 2) -> Tuple[int, int]:
    """(FLOPs, bytes) of one decode attention over ``clen`` filled rows: q
    read, the rows of K and V read, o written, each once."""
    flops = 4 * B * H * D * clen
    nbytes = elt * (2 * B * H * D + 2 * B * Hkv * clen * D)
    return flops, nbytes


def dense_layer_params(c: Dict) -> int:
    """Weights of one dense layer's products (attention and SwiGLU MLP)."""
    d, H, Hkv, D, f = (c["hidden_size"], c["num_attention_heads"], c["num_key_value_heads"],
                       c["head_dim"], c["intermediate_size"])
    return 2 * d * H * D + 2 * d * Hkv * D + 3 * d * f


def _attn_flops(c: Dict, B: int, pairs: int) -> int:
    return 4 * B * c["num_attention_heads"] * c["head_dim"] * pairs * c["num_hidden_layers"]


def prefill_flops(c: Dict, S: int) -> int:
    """Model FLOPs of one prompt's prefill of S tokens (no logits: the
    engine's prefill only fills the cache)."""
    n = dense_layer_params(c) * c["num_hidden_layers"]
    return 2 * n * S + _attn_flops(c, 1, causal_pairs(S))


def decode_flops(c: Dict, B: int, clen: int) -> int:
    """Model FLOPs of one decode step of B tokens, each attending to ``clen``
    positions (its own included), with the logits."""
    n = dense_layer_params(c) * c["num_hidden_layers"]
    return 2 * n * B + _attn_flops(c, B, clen) + 2 * B * c["hidden_size"] * c["vocab_size"]


def train_flops(c: Dict, B: int, S: int) -> int:
    """Model FLOPs of one training step on B x S tokens: forward and backward
    (three times the forward) of the layers, the causal attention and the
    logits; the recompute of remat is not counted."""
    n = dense_layer_params(c) * c["num_hidden_layers"]
    T = B * S
    fwd = 2 * n * T + _attn_flops(c, B, causal_pairs(S)) + 2 * T * c["hidden_size"] * c["vocab_size"]
    return 3 * fwd
