"""granite-3-2b — dense GQA [hf:ibm-granite/granite-3.0-2b-base]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="granite-3-2b",
    family="dense",
    source="hf:ibm-granite/granite-3.0-2b-base",
    n_layers=40,
    d_model=2048,
    n_heads=32,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=49155,
    activation="silu",
    norm="rmsnorm",
    tie_embeddings=True,
    rope_theta=1e4,
)
