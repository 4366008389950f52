"""jamba-1.5-large-398b — hybrid Mamba+attention 1:7 interleave, MoE 16e top-2
[arXiv:2403.19887].

Layer layout: period-8 blocks with one attention layer per block (position 4),
seven Mamba layers; MoE replaces the dense FFN every other layer (period 2),
16 experts top-2 — matching the Jamba block design.
"""
from repro_torch.configs.base import MambaConfig, MoEConfig, ModelConfig

CONFIG = ModelConfig(
    arch_id="jamba-1.5-large-398b",
    family="hybrid",
    source="arXiv:2403.19887",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24576,
    vocab_size=65536,
    activation="silu",
    norm="rmsnorm",
    rope_theta=1e6,
    attn_period=8,
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2),
    moe=MoEConfig(n_experts=16, top_k=2, d_ff_expert=24576, moe_period=2),
)
