"""Zamba2-7B: 81L d3584 32H (kv=32) d_ff=14336 vocab=32000, ssm_state=64.
Hybrid Mamba2 backbone with a SHARED attention block applied periodically.
Layer layout here: 3 Mamba2 prologue + 13 x [5 Mamba2 + shared attn] = 81.
[arXiv:2411.15242]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    num_layers=81,
    d_model=3584,
    num_heads=32,
    num_kv_heads=32,
    head_dim=112,
    d_ff=14336,
    vocab_size=32000,
    ssm_state=64,
    ssm_expand=2,
    ssm_conv=4,
    hybrid_prologue=3,
    hybrid_groups=13,
    hybrid_mamba_per_group=5,
    norm="rmsnorm",
    mlp="swiglu",
    tie_embeddings=True,
    notes="Mamba2 + shared attention blocks (one weight set reused)",
)
