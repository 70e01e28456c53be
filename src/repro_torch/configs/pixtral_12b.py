"""Pixtral-12B: 40L d5120 32H (GQA kv=8) d_ff=14336 vocab=131072.
Mistral-Nemo-style backbone (head_dim=128 explicit); pixtral-ViT frontend is
a STUB — input_specs() provides precomputed patch embeddings.
[hf:mistralai/Pixtral-12B-2409]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b",
    family="vlm",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=131072,
    rope_theta=1_000_000.0,
    norm="rmsnorm",
    mlp="swiglu",
    frontend="patch_stub",
    frontend_len=1024,   # patch positions provided as precomputed embeddings
    notes="pixtral-ViT frontend stubbed; mistral-nemo backbone",
)
