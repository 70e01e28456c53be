"""Llama-3 family attention workloads (paper Table 6) used by the Sim-FA
validation benchmarks (Figs. 6, 8, 9), plus a full llama3-8b ModelConfig as
an extra selectable arch."""
from dataclasses import dataclass

from repro_torch.configs.base import ModelConfig


@dataclass(frozen=True)
class AttnWorkload:
    """One FlashAttention kernel invocation (paper Table 1/6 notation)."""
    name: str
    B: int          # batch
    L: int          # query length
    S: int          # kv length
    H_kv: int       # kv heads
    G: int          # query group size (Q heads per KV head)
    D: int          # head dim
    P: int = 2      # bytes per element (fp16/bf16)
    causal: bool = False


# Table 6 of the paper.
LLAMA3_8B = dict(H_q=32, H_kv=8, G=4, D=128)
LLAMA3_70B = dict(H_q=64, H_kv=8, G=8, D=128)
LLAMA3_405B = dict(H_q=128, H_kv=8, G=16, D=128)

FAMILY = {"8B": LLAMA3_8B, "70B": LLAMA3_70B, "405B": LLAMA3_405B}


def workload(model: str, seqlen: int, batch: int = 1, causal: bool = False) -> AttnWorkload:
    f = FAMILY[model]
    return AttnWorkload(name=f"llama3-{model}-s{seqlen}", B=batch, L=seqlen,
                        S=seqlen, H_kv=f["H_kv"], G=f["G"], D=f["D"],
                        causal=causal)


CONFIG = ModelConfig(
    name="llama3-8b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=128256,
    rope_theta=500_000.0,
    norm="rmsnorm",
    mlp="swiglu",
    notes="paper's own validation model family (Table 6)",
)
