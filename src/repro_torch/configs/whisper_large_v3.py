"""Whisper-large-v3: enc-dec, 32L enc + 32L dec, d1280 20H (MHA kv=20)
d_ff=5120 vocab=51866. Conv frontend is a STUB: input_specs() provides
precomputed frame embeddings. [arXiv:2212.04356]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family="encdec",
    num_layers=32,
    enc_layers=32,
    dec_layers=32,
    d_model=1280,
    num_heads=20,
    num_kv_heads=20,
    head_dim=64,
    d_ff=5120,
    vocab_size=51866,
    norm="layernorm",
    mlp="gelu_mlp",
    bias=True,
    causal=True,
    frontend="frame_stub",
    frontend_len=1500,
    notes="enc-dec; conv frontend stubbed (precomputed frame embeddings)",
)
