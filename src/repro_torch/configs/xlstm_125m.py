"""xlstm-125m — sLSTM + mLSTM blocks [arXiv:2405.04517].

Block pattern follows the xLSTM[7:1] style at small scale: positions 3 and 9
are sLSTM, the rest mLSTM. d_ff=0: xLSTM blocks carry their own up/down
projections instead of a separate FFN.
"""
from repro_torch.configs.base import ModelConfig

_PATTERN = tuple("slstm" if i in (3, 9) else "mlstm" for i in range(12))

CONFIG = ModelConfig(
    arch_id="xlstm-125m",
    family="ssm",
    source="arXiv:2405.04517",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    activation="gelu",
    norm="layernorm",
    block_pattern=_PATTERN,
)
