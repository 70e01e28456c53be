"""RWKV6-7B (Finch): 32L d4096 attention-free, d_ff=14336 vocab=65536.
Data-dependent decay linear RNN; head size 64 -> 64 heads.
[arXiv:2404.05892]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b",
    family="ssm",
    num_layers=32,
    d_model=4096,
    num_heads=64,          # rwkv heads = d_model / rwkv_head_dim
    num_kv_heads=64,
    head_dim=64,
    d_ff=14336,
    vocab_size=65536,
    rwkv_head_dim=64,
    norm="layernorm",
    mlp="gelu_mlp",        # rwkv channel-mix (squared relu in paper; gelu-family)
    notes="Finch: data-dependent decay; attention-free",
)
