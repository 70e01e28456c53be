"""Config dataclasses for architectures, input shapes, and runs.

Every assigned architecture is expressed as a :class:`ModelConfig`. The full
configs are exercised only through the multi-pod dry-run (ShapeDtypeStruct,
no allocation); smoke tests use :meth:`ModelConfig.reduced`.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple


# ---------------------------------------------------------------------------
# Input shapes (assigned): every LM arch is paired with these four shapes.
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


# ---------------------------------------------------------------------------
# Model configuration
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | hybrid | ssm | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // num_heads

    # --- attention details ---
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    causal: bool = True

    # --- norm / mlp ---
    norm: str = "rmsnorm"            # rmsnorm | layernorm | nonparam_ln
    mlp: str = "swiglu"              # swiglu | geglu | gelu_mlp
    tie_embeddings: bool = False
    bias: bool = False               # linear-layer bias (whisper: True)

    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25

    # --- SSM / hybrid ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 128
    # zamba-style hybrid: prologue mamba layers, then groups of
    # [mamba_per_group mamba + 1 SHARED attention block]
    hybrid_prologue: int = 0
    hybrid_groups: int = 0
    hybrid_mamba_per_group: int = 0

    # --- rwkv ---
    rwkv_head_dim: int = 64

    # --- enc-dec ---
    enc_layers: int = 0              # encoder layers (encdec only)
    dec_layers: int = 0

    # --- vlm / audio stub frontend ---
    frontend: str = "none"           # none | patch_stub | frame_stub
    frontend_len: int = 0            # positions supplied as precomputed embeds

    # --- numerics ---
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"

    # --- schedule (minicpm WSD) ---
    lr_schedule: str = "cosine"      # cosine | wsd

    notes: str = ""

    # ------------------------------------------------------------------
    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    @property
    def q_group_size(self) -> int:
        return self.num_heads // max(self.num_kv_heads, 1)

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Whether 500k-token decode is architecturally sensible."""
        return self.family in ("ssm", "hybrid")

    # ------------------------------------------------------------------
    def supports_shape(self, shape: ShapeConfig) -> Tuple[bool, str]:
        """(supported, reason-if-not)."""
        if shape.name == "long_500k" and not self.sub_quadratic:
            return False, "pure full-attention arch; long_500k skipped per assignment"
        if self.family == "encdec" and shape.kind == "train" and shape.seq_len > 8192:
            return True, ""
        return True, ""

    # ------------------------------------------------------------------
    def param_count(self) -> int:
        """Analytic parameter count (used for 6ND roofline maths)."""
        d, v = self.d_model, self.vocab_size
        hd = self.head_dim
        attn = d * (self.num_heads * hd) + 2 * d * (self.num_kv_heads * hd) \
            + (self.num_heads * hd) * d
        if self.mlp in ("swiglu", "geglu"):
            mlp_dense = 3 * d * self.d_ff
        else:
            mlp_dense = 2 * d * self.d_ff
        emb = v * d * (1 if self.tie_embeddings else 2)

        if self.family == "moe":
            mlp = self.num_experts * mlp_dense + d * self.num_experts  # + router
            per_layer = attn + mlp
            return self.num_layers * per_layer + emb
        if self.family == "ssm":  # rwkv6
            d_in = d
            tmix = 4 * d * d_in + 6 * d * 32 * 2 + d_in  # r,k,v,o + lora-ish mixers
            cmix = 2 * d * self.d_ff
            return self.num_layers * (tmix + cmix) + emb
        if self.family == "hybrid":
            d_inner = self.ssm_expand * d
            mamba = d * 2 * d_inner + d_inner * d + d_inner * (self.ssm_conv + 3) \
                + 2 * d_inner * self.ssm_state
            n_mamba = self.hybrid_prologue + self.hybrid_groups * self.hybrid_mamba_per_group
            shared_attn = attn + mlp_dense  # ONE shared block
            return n_mamba * mamba + shared_attn + emb
        if self.family == "encdec":
            enc = self.enc_layers * (attn + mlp_dense)
            dec = self.dec_layers * (2 * attn + mlp_dense)  # self + cross
            return enc + dec + emb
        # dense / vlm backbone
        return self.num_layers * (attn + mlp_dense) + emb

    def active_param_count(self) -> int:
        """Activated params per token (MoE: only routed experts)."""
        if self.family != "moe":
            return self.param_count()
        d = self.d_model
        hd = self.head_dim
        attn = d * (self.num_heads * hd) + 2 * d * (self.num_kv_heads * hd) \
            + (self.num_heads * hd) * d
        mlp_dense = 3 * d * self.d_ff
        per_layer = attn + self.experts_per_token * mlp_dense
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return self.num_layers * per_layer + emb

    # ------------------------------------------------------------------
    def reduced(self) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests."""
        kw = dataclasses.asdict(self)
        kw.update(
            name=self.name + "-reduced",
            num_layers=min(self.num_layers, 2),
            d_model=64,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 4) if self.num_kv_heads else 0,
            head_dim=16,
            d_ff=128,
            vocab_size=256,
        )
        if self.family == "moe":
            kw.update(num_experts=4, experts_per_token=2)
        if self.family in ("hybrid",):
            kw.update(hybrid_prologue=1, hybrid_groups=1, hybrid_mamba_per_group=1,
                      ssm_state=8, num_layers=3)
        if self.family == "ssm":
            kw.update(rwkv_head_dim=16, num_layers=2)
        if self.family == "encdec":
            kw.update(enc_layers=2, dec_layers=2, num_layers=2)
        if self.frontend != "none":
            kw.update(frontend_len=8)
        if self.num_kv_heads > 4:
            kw.update(num_kv_heads=4)
        if self.num_kv_heads and self.num_kv_heads == self.num_heads:
            kw.update(num_kv_heads=4)  # keep MHA shape-consistent
        return ModelConfig(**kw)
