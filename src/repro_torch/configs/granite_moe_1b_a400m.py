"""granite-moe-1b-a400m — MoE 32 experts top-8
[hf:ibm-granite/granite-3.0-1b-a400m-base]."""
from repro_torch.configs.base import MoEConfig, ModelConfig

CONFIG = ModelConfig(
    arch_id="granite-moe-1b-a400m",
    family="moe",
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=512,
    vocab_size=49155,
    activation="silu",
    norm="rmsnorm",
    tie_embeddings=True,
    rope_theta=1e4,
    moe=MoEConfig(n_experts=32, top_k=8, d_ff_expert=512, moe_period=1),
)
