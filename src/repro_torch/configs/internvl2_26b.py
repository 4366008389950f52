"""internvl2-26b — VLM: InternViT-6B frontend (stub) + InternLM2-20B backbone
[arXiv:2404.16821].

Per the assignment, the vision encoder is a STUB: `input_specs` supplies
pre-projector patch features [B, n_prefix_tokens, d_frontend]; the framework
implements the MLP projector + the full language backbone.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="internvl2-26b",
    family="vlm",
    source="arXiv:2404.16821",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab_size=92553,
    activation="silu",
    norm="rmsnorm",
    rope_theta=1e6,
    d_frontend=3200,          # InternViT-6B hidden size
    n_prefix_tokens=256,      # image tokens per request (pixel-unshuffled ViT patches)
)
