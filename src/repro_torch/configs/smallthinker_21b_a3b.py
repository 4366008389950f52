"""smallthinker-21b-a3b — 52 layers, hidden 2,560, 28 query / 4 KV heads of
128, a 4,096-position window with RoPE (theta 1.5e6) on three layers of
four and full attention without positional encoding on the fourth, and on
every layer 64 ReGLU experts of 768, top 6 of a softmax renormalised,
routed from the attention's input
[hf:PowerInfer/SmallThinker-21BA3B-Instruct].

Read from the model's config.json: `sliding_window_layout` / `rope_layout`
(period 4, layer 0 full and NoPE), `sliding_window_size` 4096,
`moe_num_primary_experts` 64, `moe_num_active_primary_experts` 6,
`moe_ffn_hidden_size` 768, `moe_primary_router_apply_softmax`,
`norm_topk_prob`, `head_dim` 128, `rms_norm_eps` 1e-6 (the port's RMSNorm
eps), no tied embeddings. From the family's description, not the config:
the router reads the attention's input, and the experts are ReGLU. Its
"secondary experts" are not sized by the config and are not built. No
expert is ever dropped (`MoEConfig.dropless`).
"""
import dataclasses

from repro_torch.configs.base import MoEConfig, ModelConfig

CONFIG = ModelConfig(
    arch_id="smallthinker-21b-a3b",
    family="moe",
    source="hf:PowerInfer/SmallThinker-21BA3B-Instruct",
    n_layers=52,
    d_model=2560,
    n_heads=28,
    n_kv_heads=4,
    head_width=128,
    d_ff=0,
    vocab_size=151936,
    activation="relu",
    norm="rmsnorm",
    tie_embeddings=False,
    rope_theta=1.5e6,
    max_seq_len=16384,
    sliding_window=4096,
    attn_layout=("nope", "window", "window", "window"),
    flash_triangular=True,
    moe=MoEConfig(n_experts=64, top_k=6, d_ff_expert=768, moe_period=1,
                  activation="relu", router_input="pre_attention",
                  dropless=True),
)


def reduced(**overrides) -> ModelConfig:
    """Two periods of the layout at CPU-test widths. The head width stays
    unequal to d_model / n_heads (14 x 16 = 224 against 64) and the query
    heads a KV head serves stay 7, not a power of two; the window is short
    enough for a test's prompt to pass it."""
    changes = dict(n_layers=8, d_model=64, n_heads=14, n_kv_heads=2,
                   head_width=16, vocab_size=256, max_seq_len=512,
                   sliding_window=12, remat=False,
                   moe=dataclasses.replace(CONFIG.moe, n_experts=8, top_k=3,
                                           d_ff_expert=32))
    changes.update(overrides)
    return dataclasses.replace(CONFIG, **changes)
