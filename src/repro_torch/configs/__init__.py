"""Config registry: the 10 assigned architectures + the paper's own models."""
from __future__ import annotations

from typing import Dict

from repro_torch.configs import (granite_3_2b, granite_34b, granite_moe_1b_a400m,
                           granite_moe_3b_a800m, internlm2_20b, internvl2_26b,
                           jamba_1_5_large_398b, qwen2_7b, seamless_m4t_medium,
                           xlstm_125m)
from repro_torch.configs.base import (INPUT_SHAPES, InputShape, MambaConfig, MoEConfig,
                                ModelConfig, reduced_config)
from repro_torch.configs.paper_models import (PAPER_MODELS, PAPER_NEURONS,
                                        PAPER_SPARSITY)

ASSIGNED_CONFIGS: Dict[str, ModelConfig] = {
    c.CONFIG.arch_id: c.CONFIG
    for c in (
        internlm2_20b, internvl2_26b, granite_moe_1b_a400m, granite_34b,
        granite_3_2b, granite_moe_3b_a800m, jamba_1_5_large_398b, xlstm_125m,
        seamless_m4t_medium, qwen2_7b,
    )
}

ALL_CONFIGS: Dict[str, ModelConfig] = {**ASSIGNED_CONFIGS, **PAPER_MODELS}


def get_config(arch_id: str, reduced: bool = False, **overrides) -> ModelConfig:
    if arch_id not in ALL_CONFIGS:
        raise KeyError(f"unknown arch '{arch_id}'; known: {sorted(ALL_CONFIGS)}")
    cfg = ALL_CONFIGS[arch_id]
    if reduced:
        cfg = reduced_config(cfg, **overrides)
    elif overrides:
        import dataclasses
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg


__all__ = [
    "ModelConfig", "MoEConfig", "MambaConfig", "InputShape", "INPUT_SHAPES",
    "ASSIGNED_CONFIGS", "ALL_CONFIGS", "PAPER_MODELS", "PAPER_SPARSITY",
    "PAPER_NEURONS", "get_config", "reduced_config",
]
