"""Model configuration schema + input-shape registry.

Every assigned architecture gets one file in this package defining `CONFIG`
(the exact assigned hyper-parameters, source cited) and `reduced()` (a tiny
same-family variant for CPU smoke tests). `repro_torch.configs.get_config(arch_id)`
resolves either.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    moe_period: int = 1        # every `period`-th layer is MoE (1 = all layers)
    router_aux_weight: float = 0.01
    activation: str = "silu"   # the gate's activation: silu (SwiGLU) | relu (ReGLU)
    # the router's input: "post_attention" (the FFN's own normed input) or
    # "pre_attention" (the attention's normed input, routed before it runs)
    router_input: str = "post_attention"
    # True: every routed (token, expert) pair is computed, none dropped
    # (`moe.moe_forward_dropless`); False: the capacity-bound dispatch
    dropless: bool = False


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str                 # dense | moe | ssm | hybrid | vlm | audio
    source: str                 # citation from the assignment
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    activation: str = "silu"    # relu | silu | gelu | relu2
    norm: str = "rmsnorm"       # rmsnorm | layernorm
    qkv_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 1e6
    max_seq_len: int = 524_288
    sliding_window: int = 8_192   # SWA window used only by the long_500k decode path
    # per-layer attention, cycled over the stack: "global" (RoPE, the
    # window the caller passes), "window" (RoPE, `sliding_window`) or
    # "nope" (no positional encoding, the window the caller passes);
    # () is "global" everywhere
    attn_layout: Tuple[str, ...] = ()
    head_width: int = 0         # per-head width; 0: d_model // n_heads
    # -- family extensions --
    moe: Optional[MoEConfig] = None
    mamba: Optional[MambaConfig] = None
    attn_period: int = 0        # hybrid: one attention layer per `attn_period` layers (0 = all attn)
    block_pattern: Tuple[str, ...] = ()   # ssm (xlstm): per-layer block kinds, cycled
    n_enc_layers: int = 0       # audio enc-dec: encoder depth (n_layers = decoder depth)
    d_frontend: int = 0         # vlm/audio: stub frontend embedding dim (pre-projector)
    n_prefix_tokens: int = 0    # vlm: image tokens per sequence; audio: encoder frames
    # -- numerics --
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    remat: bool = True
    # -- perf variants (§Perf hillclimbing; defaults = paper-faithful baseline) --
    flash_triangular: bool = False   # causal flash skips fully-masked KV blocks
    flash_q_chunk: int = 1024
    flash_k_chunk: int = 1024
    serve_sparse: bool = False       # decode FFN via predictor + segment top-k
    sparse_seg: int = 128            # neuron segment width (kernels/sparse_ffn)
    sparse_frac: float = 0.15        # fraction of segments gathered per step
    kv_quant: bool = False           # int8 KV cache (halves decode KV streaming)

    @property
    def head_dim(self) -> int:
        return self.head_width or self.d_model // self.n_heads

    @property
    def is_encdec(self) -> bool:
        return self.n_enc_layers > 0

    def dtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer mixer kind: 'attn' | 'mamba' | 'slstm' | 'mlstm'."""
        if self.family == "ssm":
            pat = self.block_pattern or ("mlstm",)
            return tuple(pat[i % len(pat)] for i in range(self.n_layers))
        if self.family == "hybrid" and self.attn_period > 0:
            return tuple(
                "attn" if i % self.attn_period == self.attn_period // 2 else "mamba"
                for i in range(self.n_layers)
            )
        return ("attn",) * self.n_layers

    def attn_kinds(self) -> Tuple[str, ...]:
        """Per-layer attention kind: 'global' | 'window' | 'nope'."""
        pat = self.attn_layout or ("global",)
        return tuple(pat[i % len(pat)] for i in range(self.n_layers))

    def ffn_kinds(self) -> Tuple[str, ...]:
        """Per-layer FFN kind: 'dense' | 'moe' | 'none'."""
        if self.d_ff == 0 and self.moe is None:
            return ("none",) * self.n_layers
        if self.moe is None:
            return ("dense",) * self.n_layers
        p = self.moe.moe_period
        return tuple("moe" if i % p == p - 1 else "dense" for i in range(self.n_layers))

    def param_count(self) -> int:
        """Approximate parameter count (used for 6ND model-FLOPs accounting)."""
        d, L = self.d_model, self.n_layers
        hd, H, KV = self.head_dim, self.n_heads, self.n_kv_heads
        total = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        kinds, ffns = self.layer_kinds(), self.ffn_kinds()
        for kind, ffn in zip(kinds, ffns):
            if kind == "attn":
                total += d * hd * (H + 2 * KV) + H * hd * d
            elif kind == "mamba":
                m = self.mamba or MambaConfig()
                di = m.expand * d
                total += d * di * 2 + di * m.d_conv + di * (2 * m.d_state + 2) + di * d
            elif kind in ("mlstm", "slstm"):
                total += 4 * d * d + 3 * self.n_heads * self.head_dim * d
            if ffn == "dense":
                total += 3 * d * self.d_ff if self.activation != "relu" or True else 0
            elif ffn == "moe":
                assert self.moe is not None
                total += self.moe.n_experts * 3 * d * self.moe.d_ff_expert + d * self.moe.n_experts
        if self.is_encdec:
            for _ in range(self.n_enc_layers):
                total += d * hd * (H + 2 * KV) + H * hd * d + 3 * d * self.d_ff
            total += L * (d * hd * (H + 2 * KV) + H * hd * d)  # cross-attention
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k experts instead of all)."""
        if self.moe is None:
            return self.param_count()
        total = self.param_count()
        n_moe = sum(1 for f in self.ffn_kinds() if f == "moe")
        full = n_moe * self.moe.n_experts * 3 * self.d_model * self.moe.d_ff_expert
        act = n_moe * self.moe.top_k * 3 * self.d_model * self.moe.d_ff_expert
        return total - full + act


# ---------------------------------------------------------------------------
# Input shapes (assigned)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                   # train | prefill | decode


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


def reduced_config(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Tiny same-family variant: 2 layers, d_model<=512, <=4 experts."""
    changes = dict(
        n_layers=2,
        d_model=min(cfg.d_model, 256),
        n_heads=min(cfg.n_heads, 4),
        n_kv_heads=min(cfg.n_kv_heads, 2),
        d_ff=min(cfg.d_ff, 512) if cfg.d_ff else 0,
        vocab_size=min(cfg.vocab_size, 512),
        max_seq_len=4_096,
        sliding_window=64,
        remat=False,
    )
    if cfg.moe is not None:
        changes["moe"] = MoEConfig(
            n_experts=min(cfg.moe.n_experts, 4),
            top_k=min(cfg.moe.top_k, 2),
            d_ff_expert=min(cfg.moe.d_ff_expert, 128),
            capacity_factor=cfg.moe.capacity_factor,
            moe_period=min(cfg.moe.moe_period, 2),
        )
    if cfg.family == "hybrid":
        changes["n_layers"] = 4
        changes["attn_period"] = min(cfg.attn_period, 4) or 4
    if cfg.n_enc_layers:
        changes["n_enc_layers"] = 2
    if cfg.d_frontend:
        changes["d_frontend"] = min(cfg.d_frontend, 128)
        changes["n_prefix_tokens"] = min(cfg.n_prefix_tokens, 16)
    # keep head_dim divisibility
    d = changes["d_model"]
    changes["n_heads"] = max(1, min(changes["n_heads"], d // 32))
    changes["n_kv_heads"] = max(1, min(changes["n_kv_heads"], changes["n_heads"]))
    while d % changes["n_heads"]:
        changes["n_heads"] -= 1
    while changes["n_heads"] % changes["n_kv_heads"]:
        changes["n_kv_heads"] -= 1
    changes.update(overrides)
    return dataclasses.replace(cfg, **changes)
