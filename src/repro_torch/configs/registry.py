"""Architecture registry: ``--arch <id>`` ids map to ModelConfigs."""
from __future__ import annotations

from typing import Dict, Iterator, Tuple

from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig
from repro_torch.configs import (
    dbrx_132b, grok_1_314b, olmo_1b, command_r_plus_104b, minicpm_2b,
    qwen2_5_3b, zamba2_7b, pixtral_12b, rwkv6_7b, whisper_large_v3, llama3,
)

# The 10 assigned architectures (+ the paper's own llama3-8b as an extra).
ARCHS: Dict[str, ModelConfig] = {
    "dbrx-132b": dbrx_132b.CONFIG,
    "grok-1-314b": grok_1_314b.CONFIG,
    "olmo-1b": olmo_1b.CONFIG,
    "command-r-plus-104b": command_r_plus_104b.CONFIG,
    "minicpm-2b": minicpm_2b.CONFIG,
    "qwen2.5-3b": qwen2_5_3b.CONFIG,
    "zamba2-7b": zamba2_7b.CONFIG,
    "pixtral-12b": pixtral_12b.CONFIG,
    "rwkv6-7b": rwkv6_7b.CONFIG,
    "whisper-large-v3": whisper_large_v3.CONFIG,
    "llama3-8b": llama3.CONFIG,   # extra: the paper's validation family
}

ASSIGNED = [a for a in ARCHS if a != "llama3-8b"]


def get(arch: str) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCHS)}")
    return ARCHS[arch]


def cells(include_extra: bool = False) -> Iterator[Tuple[ModelConfig, ShapeConfig, bool, str]]:
    """All (arch x shape) cells. Yields (cfg, shape, supported, reason)."""
    names = list(ARCHS) if include_extra else ASSIGNED
    for a in names:
        cfg = ARCHS[a]
        for shape in SHAPES.values():
            ok, why = cfg.supports_shape(shape)
            yield cfg, shape, ok, why
