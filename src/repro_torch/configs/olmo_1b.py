"""OLMo-1B: 16L d2048 16H (MHA kv=16) d_ff=8192 vocab=50304, non-parametric
LayerNorm. [arXiv:2402.00838]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="olmo-1b",
    family="dense",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=8192,
    vocab_size=50304,
    norm="nonparam_ln",
    mlp="swiglu",
    tie_embeddings=True,
    notes="non-parametric LN",
)
