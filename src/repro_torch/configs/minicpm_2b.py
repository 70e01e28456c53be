"""MiniCPM-2B: 40L d2304 36H (MHA kv=36) d_ff=5760 vocab=122753, llama-like,
trained with the WSD schedule. [arXiv:2404.06395]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minicpm-2b",
    family="dense",
    num_layers=40,
    d_model=2304,
    num_heads=36,
    num_kv_heads=36,
    head_dim=64,
    d_ff=5760,
    vocab_size=122753,
    norm="rmsnorm",
    mlp="swiglu",
    tie_embeddings=True,
    lr_schedule="wsd",
    notes="WSD schedule; llama-like",
)
