"""The paper's own evaluation models (Table 3) — ReLU-sparse variants.

Used by the benchmarks reproducing the paper's tables/figures. Neuron counts
match Table 3 (neurons per FFN block; 2 linear layers in OPT, 3 in others).
"""
from repro_torch.configs.base import ModelConfig

OPT_350M = ModelConfig(
    arch_id="opt-350m", family="dense", source="arXiv:2205.01068 (paper Table 3)",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16, d_ff=4096,
    vocab_size=50272, activation="relu", norm="layernorm", rope_theta=1e4,
)

OPT_1_3B = ModelConfig(
    arch_id="opt-1.3b", family="dense", source="arXiv:2205.01068 (paper Table 3)",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32, d_ff=8192,
    vocab_size=50272, activation="relu", norm="layernorm", rope_theta=1e4,
)

OPT_6_7B = ModelConfig(
    arch_id="opt-6.7b", family="dense", source="arXiv:2205.01068 (paper Table 3)",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=32, d_ff=16384,
    vocab_size=50272, activation="relu", norm="layernorm", rope_theta=1e4,
)

LLAMA2_7B_RELU = ModelConfig(
    arch_id="llama2-7b-relu", family="dense", source="arXiv:2307.09288 + ProSparse relu variant (paper Table 3)",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=32, d_ff=11008,
    vocab_size=32000, activation="relu", norm="rmsnorm", rope_theta=1e4,
)

MISTRAL_7B_RELU = ModelConfig(
    arch_id="mistral-7b-relu", family="dense", source="arXiv:2310.06825 + TurboSparse relu variant (paper Table 3)",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab_size=32000, activation="relu", norm="rmsnorm", rope_theta=1e4,
)

# Paper Table 3 sparsity ratios (fraction of neurons ACTIVATED per token).
PAPER_SPARSITY = {
    "opt-350m": 0.0949,
    "opt-1.3b": 0.0409,
    "opt-6.7b": 0.0328,
    "llama2-7b-relu": 0.1388,
    "mistral-7b-relu": 0.6052,
}

# Neurons per FFN block and matrices per bundle (Table 3 footnote).
PAPER_NEURONS = {
    "opt-350m": (4096, 2),
    "opt-1.3b": (8192, 2),
    "opt-6.7b": (16384, 2),
    "llama2-7b-relu": (11008, 3),
    "mistral-7b-relu": (14336, 3),
}

PAPER_MODELS = {
    m.arch_id: m for m in (OPT_350M, OPT_1_3B, OPT_6_7B, LLAMA2_7B_RELU, MISTRAL_7B_RELU)
}
