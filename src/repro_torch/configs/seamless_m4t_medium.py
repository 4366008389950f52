"""seamless-m4t-medium — encoder-decoder, multimodal (speech/text)
[arXiv:2308.11596].

The audio frontend (mel-spectrogram + conv feature extractor) is a STUB per
the assignment: `input_specs` provides precomputed frame embeddings
[B, n_prefix_tokens, d_frontend] consumed by the 12-layer text/unit encoder;
the 12-layer decoder cross-attends to encoder output. n_layers counts the
decoder stack; n_enc_layers the encoder stack.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="seamless-m4t-medium",
    family="audio",
    source="arXiv:2308.11596",
    n_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=256206,
    activation="relu",
    norm="layernorm",
    rope_theta=1e4,
    n_enc_layers=12,
    d_frontend=1024,          # w2v-BERT conv frontend output dim
    n_prefix_tokens=1024,     # encoder frames per request
)
