"""Architecture config registry: `get_config(arch_id)` (counterpart of
`repro.configs`; the config files are copied as data)."""
from __future__ import annotations

from repro_torch.configs import (
    command_r_35b,
    command_r_plus_104b,
    deepseek_moe_16b,
    kimi_k2_1t_a32b,
    llama_3_2_vision_90b,
    mamba2_1_3b,
    minicpm3_4b,
    musicgen_medium,
    qwen3_0_6b,
    zamba2_1_2b,
)
from repro_torch.configs.base import reduce_config
from repro_torch.types import ModelConfig

REGISTRY: dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (
        llama_3_2_vision_90b,
        mamba2_1_3b,
        command_r_35b,
        qwen3_0_6b,
        command_r_plus_104b,
        minicpm3_4b,
        deepseek_moe_16b,
        kimi_k2_1t_a32b,
        zamba2_1_2b,
        musicgen_medium,
    )
}

ARCH_IDS = list(REGISTRY)


def get_config(name: str, reduced: bool = False) -> ModelConfig:
    cfg = REGISTRY[name]
    return reduce_config(cfg) if reduced else cfg
