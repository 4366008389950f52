"""granite-34b — dense MQA (kv=1) code model, llama-arch [arXiv:2405.04324]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="granite-34b",
    family="dense",
    source="arXiv:2405.04324",
    n_layers=88,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    d_ff=24576,
    vocab_size=49152,
    activation="gelu",        # granite code models use GELU MLPs
    norm="layernorm",
    rope_theta=1e5,
)
