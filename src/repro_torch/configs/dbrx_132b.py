"""DBRX-132B: 40L d6144 48H (GQA kv=8) d_ff=10752/expert, MoE 16e top-4
(fine-grained experts). [hf:databricks/dbrx-base]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    family="moe",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=10752,
    vocab_size=100352,
    num_experts=16,
    experts_per_token=4,
    rope_theta=500_000.0,
    norm="layernorm",
    mlp="swiglu",
    notes="fine-grained MoE, 16 experts top-4",
)
