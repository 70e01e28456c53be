"""``perfbench/counts.py`` on shapes worked out by hand."""
import pytest

from perfbench import counts


def test_causal_pairs():
    assert counts.causal_pairs(1) == 1
    assert counts.causal_pairs(4) == 10           # 1 + 2 + 3 + 4


def test_flash_fwd():
    # B 1, H 2, Hkv 1, L = S = 4, D 8, causal: 10 kept pairs, two products
    f, b = counts.flash_fwd(1, 2, 1, 4, 4, 8, causal=True)
    assert f == 4 * 2 * 8 * 10
    assert b == 2 * (2 * 2 * 4 * 8 + 2 * 1 * 4 * 8)      # q and o; k and v
    f, _ = counts.flash_fwd(1, 2, 1, 4, 4, 8, causal=False)
    assert f == 4 * 2 * 8 * 16


def test_flash_decode_reads_cache_len_rows():
    f, b = counts.flash_decode(2, 4, 2, 8, 5)
    assert f == 4 * 2 * 4 * 8 * 5
    assert b == 2 * (2 * 2 * 4 * 8 + 2 * 2 * 2 * 5 * 8)


C = {"hidden_size": 4, "num_attention_heads": 2, "num_key_value_heads": 1, "head_dim": 2,
     "intermediate_size": 8, "vocab_size": 10, "num_hidden_layers": 3}


def test_dense_layer_params():
    # wq, wo: 4 x 4 each; wk, wv: 4 x 2 each; SwiGLU: 3 x 4 x 8
    assert counts.dense_layer_params(C) == 32 + 16 + 96


def test_model_flops():
    n = 144 * 3
    assert counts.prefill_flops(C, 4) == 2 * n * 4 + 4 * 1 * 2 * 2 * 10 * 3
    assert counts.decode_flops(C, 2, 7) == 2 * n * 2 + 4 * 2 * 2 * 2 * 7 * 3 + 2 * 2 * 4 * 10
    fwd = 2 * n * 8 + 4 * 2 * 2 * 2 * 10 * 3 + 2 * 8 * 4 * 10
    assert counts.train_flops(C, 2, 4) == 3 * fwd


def test_roofline_takes_the_larger_bound():
    pk = {"bf16_flop_s": 1e12, "hbm_byte_s": 1e9}
    assert counts.roofline_s(2e12, 1e6, pk) == pytest.approx(2.0)
    assert counts.roofline_s(1e6, 3e9, pk) == pytest.approx(3.0)
    assert counts.peaks("NVIDIA H100 80GB HBM3")["bf16_flop_s"] == 989e12
    assert counts.peaks("no such card") is None
