"""qwen2-7b — dense GQA with QKV bias [arXiv:2407.10671]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen2-7b",
    family="dense",
    source="arXiv:2407.10671",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    d_ff=18944,
    vocab_size=152064,
    activation="silu",
    norm="rmsnorm",
    qkv_bias=True,
    rope_theta=1e6,
)
