"""Transformer building blocks: norms, RoPE, GQA attention, FFN, embeddings.

Plain functions over parameter dicts of tensors, each taking the
ModelConfig, in the layouts of the reference package (`w_up` is [d, d_ff],
`w_down` [d_ff, d], attention projections [d, heads * head_dim]) so that
weights converted from it compare like with like. Attention is the plain
einsum formulation (`gqa_attend`), used for prefill and for decode against a
KV cache. The `init_*` functions draw from a `torch.Generator` and create
their tensors on that generator's device.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.dtensor import (replicated, rows_and_heads,
                                           split_last)

Params = Dict[str, torch.Tensor]

NEG_INF = -1e30


def _normal(gen: torch.Generator, shape, dtype, std: float) -> torch.Tensor:
    return torch.randn(shape, generator=gen, dtype=dtype,
                       device=gen.device) * std


def promoted_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in the promoted dtype of the two operands, as `jnp.matmul`
    computes it (torch refuses mixed dtypes). Offload decode reaches it with
    float32 activations and bf16 weights: the offload FFN returns float32,
    which makes the residual stream float32 from the first offloaded FFN on
    (ROADMAP §3). A no-op cast when the dtypes agree."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) @ b.to(dt)


def maybe_checkpoint(cfg: ModelConfig, fn, *args):
    """`fn(*args)`, rematerialised in the backward pass when `cfg.remat`
    and autograd is recording (the reference's `jax.checkpoint` around a
    scanned layer): the same function, its activations recomputed instead
    of kept."""
    if cfg.remat and torch.is_grad_enabled():
        return torch.utils.checkpoint.checkpoint(fn, *args,
                                                 use_reentrant=False)
    return fn(*args)


# -- norms -------------------------------------------------------------------

def init_norm(cfg: ModelConfig, device, d: Optional[int] = None) -> Params:
    d = d or cfg.d_model
    p = {"scale": torch.ones((d,), dtype=cfg.pdtype(), device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=cfg.pdtype(), device=device)
    return p


def apply_norm(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    xf = x.float()
    if cfg.norm == "rmsnorm":
        var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + 1e-6) * p["scale"].float()
    else:
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.var(xf, dim=-1, keepdim=True, correction=0)
        y = (xf - mu) * torch.rsqrt(var + 1e-5) * p["scale"].float()
        y = y + p["bias"].float()
    return y.to(x.dtype)


# -- rotary position embedding ------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [B, T, N, hd]; positions: [B, T] int."""
    hd = x.shape[-1]
    half = hd // 2
    exponent = torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    freqs = 1.0 / (theta ** exponent)
    angles = positions.float()[..., None] * freqs                  # [B, T, half]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# -- attention ----------------------------------------------------------------

def init_attention(gen: torch.Generator, cfg: ModelConfig,
                   cross: bool = False) -> Params:
    """q/k/v/o projections; q/k/v biases when `cfg.qkv_bias`, except on a
    cross-attention block (`cross`), which never has them."""
    d, hd, H, KV = cfg.d_model, cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    dt = cfg.pdtype()
    std = d ** -0.5
    p: Params = {
        "wq": _normal(gen, (d, H * hd), dt, std),
        "wk": _normal(gen, (d, KV * hd), dt, std),
        "wv": _normal(gen, (d, KV * hd), dt, std),
        "wo": _normal(gen, (H * hd, d), dt, (H * hd) ** -0.5),
    }
    if cfg.qkv_bias and not cross:
        for name, width in (("bq", H * hd), ("bk", KV * hd), ("bv", KV * hd)):
            p[name] = torch.zeros((width,), dtype=dt, device=gen.device)
    return p


def _project_qkv(p: Params, xq: torch.Tensor, xkv: torch.Tensor,
                 cfg: ModelConfig):
    H, KV = cfg.n_heads, cfg.n_kv_heads
    q = promoted_matmul(xq, p["wq"])
    k = promoted_matmul(xkv, p["wk"])
    v = promoted_matmul(xkv, p["wv"])
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    # under sharding, a head count the model axis does not divide is
    # replicated before the split
    return split_last(q, H), split_last(k, KV), split_last(v, KV)


def gqa_attend(
    q: torch.Tensor,                 # [B, T, H, hd]
    k: torch.Tensor,                 # [B, S, KV, hd]
    v: torch.Tensor,                 # [B, S, KV, hd]
    q_pos: torch.Tensor,             # [B, T]
    k_pos: torch.Tensor,             # [B, S]
    k_valid: Optional[torch.Tensor] = None,   # [B, S] bool
    causal: bool = True,
    window: int = 0,
) -> torch.Tensor:
    """[B, T, H * hd]. Under sharding each rank attends its own rows and
    KV heads (`rows_and_heads`)."""
    def attend(q, k, v, q_pos, k_pos, k_valid):
        return _gqa_attend(q, k, v, q_pos, k_pos, k_valid, causal, window)
    return rows_and_heads(attend, q, (q, k, v, q_pos, k_pos, k_valid),
                          (2, 2, 2, None, None, None), k.shape[2], (2,))


def _gqa_attend(q, k, v, q_pos, k_pos, k_valid, causal, window):
    B, T, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    G = H // KV
    qg = q.reshape(B, T, KV, G, hd)
    dt = torch.promote_types(q.dtype, k.dtype)   # as jnp.einsum
    logits = torch.einsum("btkgh,bskh->bkgts", qg.to(dt), k.to(dt)).float()
    logits = logits * (hd ** -0.5)
    mask = torch.ones((B, T, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos[:, None, :] <= q_pos[:, :, None]
    if window > 0:
        mask &= q_pos[:, :, None] - k_pos[:, None, :] < window
    if k_valid is not None:
        mask &= k_valid[:, None, :]
    logits = torch.where(mask[:, None, None, :, :], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bkgts,bskh->btkgh", probs, v)
    return out.reshape(B, T, H * hd)


def attention_forward(p: Params, x: torch.Tensor, positions: torch.Tensor,
                      cfg: ModelConfig, causal: bool = True,
                      window: int = 0) -> Tuple[torch.Tensor, torch.Tensor,
                                                torch.Tensor]:
    """Self-attention over a full sequence (prefill / calibration forward).
    Returns (output [B, T, d], roped k, v) so prefill can fill its cache.

    The reference switches to chunked flash attention past 2048 positions
    to bound memory; the port keeps the plain [T, S] score matrix."""
    q, k, v = _project_qkv(p, x, x, cfg)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    out = gqa_attend(q, k, v, positions, positions, causal=causal,
                     window=window)
    return out @ p["wo"], k, v


def cross_attention_forward(p: Params, x: torch.Tensor,
                            memory_k: torch.Tensor, memory_v: torch.Tensor,
                            cfg: ModelConfig) -> torch.Tensor:
    """Attention of x [B, T, d] over the encoder memory's K/V [B, S, KV, hd]
    (from `project_memory_kv`): no rope (every position 0), not causal.
    Like `attention_forward`, the plain [T, S] score matrix at any length
    (the reference takes its chunked flash form past 2048 positions)."""
    B, T = x.shape[0], x.shape[1]
    q = split_last(x @ p["wq"], cfg.n_heads)
    S = memory_k.shape[1]
    zeros_q = torch.zeros((B, T), dtype=torch.int32, device=x.device)
    zeros_k = torch.zeros((B, S), dtype=torch.int32, device=x.device)
    out = gqa_attend(q, memory_k, memory_v, zeros_q, zeros_k, causal=False)
    return out @ p["wo"]


def project_memory_kv(p: Params, memory: torch.Tensor, cfg: ModelConfig
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The encoder memory [B, S, d] through a cross-attention block's k / v
    projections: ([B, S, KV, hd], [B, S, KV, hd])."""
    KV = cfg.n_kv_heads
    return split_last(memory @ p["wk"], KV), split_last(memory @ p["wv"], KV)


# -- FFN -----------------------------------------------------------------------

def init_ffn(gen: torch.Generator, cfg: ModelConfig) -> Params:
    d, f, dt = cfg.d_model, cfg.d_ff, cfg.pdtype()
    p: Params = {
        "w_up": _normal(gen, (d, f), dt, d ** -0.5),
        "w_down": _normal(gen, (f, d), dt, f ** -0.5),
    }
    if cfg.activation in ("silu",):   # gated (SwiGLU-family) FFN
        p["w_gate"] = _normal(gen, (d, f), dt, d ** -0.5)
    return p


def apply_activation(x: torch.Tensor, name: str) -> torch.Tensor:
    """relu | relu2 | gelu (tanh approximation, as the reference's
    `jax.nn.gelu` default) | silu."""
    if name == "relu":
        return torch.relu(x)
    if name == "silu":
        # the reference's x * logistic(x), logistic as 1 / (1 + exp(-x)),
        # each op rounded to x's dtype (F.silu rounds bf16 once)
        return x * (1 / (1 + torch.exp(-x)))
    if name == "gelu":
        return F.gelu(x, approximate="tanh")
    if name == "relu2":
        return torch.square(torch.relu(x))
    raise ValueError(f"unknown activation {name}")


def ffn_forward(p: Params, x: torch.Tensor, cfg: ModelConfig,
                capture: bool = False
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    pre = x @ p["w_up"]
    act = apply_activation(pre, cfg.activation)
    if "w_gate" in p:
        act = act * (x @ p["w_gate"])
    y = act @ p["w_down"]
    return y, (pre if capture else None)


# -- predictor-driven segment top-k decode FFN (serve_sparse) ------------------

def init_ffn_predictor(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """Per-layer predictor that scores neuron SEGMENTS (`cfg.sparse_seg`
    contiguous neurons) from the FFN input: relu(x @ w1) @ w2."""
    n_seg = cfg.d_ff // cfg.sparse_seg
    h = 128
    dt = cfg.pdtype()
    return {"w1": _normal(gen, (cfg.d_model, h), dt, cfg.d_model ** -0.5),
            "w2": _normal(gen, (h, n_seg), dt, h ** -0.5)}


def predict_segments(pred: Params, x: torch.Tensor,
                     cfg: ModelConfig) -> torch.Tensor:
    """The `k = max(1, int(n_seg * sparse_frac))` segments with the largest
    predictor scores summed over every row of x [B, T, d] (the union over
    the batch): int32 [k], highest score first."""
    B, T, d = x.shape
    n_seg = cfg.d_ff // cfg.sparse_seg
    k_seg = max(1, int(n_seg * cfg.sparse_frac))
    scores = torch.relu(x.reshape(B * T, d) @ pred["w1"].to(x.dtype))
    scores = scores @ pred["w2"].to(x.dtype)                      # [B*T, n_seg]
    union = scores.float().sum(dim=0)
    return torch.topk(union, k_seg).indices.to(torch.int32)


def sparse_ffn_decode(p: Params, pred: Params, x: torch.Tensor,
                      cfg: ModelConfig) -> torch.Tensor:
    """x: [B, T, d]. Segment-top-k FFN: only the predicted segments of
    w_up / w_gate / w_down are read, through `ops.sparse_ffn_segments` (the
    hand-written kernel on the card) on `w_up.T` / `w_gate.T` views of the
    resident [d, d_ff] weights, so no weight is copied. Exact for ReLU
    models whenever the predicted segments cover the true support."""
    from repro_torch.kernels import ops   # the kernels import this module
    B, T, d = x.shape
    y = ops.sparse_ffn_segments(
        x.reshape(B * T, d), p["w_up"].T, p["w_down"],
        predict_segments(pred, x, cfg),
        p["w_gate"].T if "w_gate" in p else None,
        seg_size=cfg.sparse_seg, activation=cfg.activation)
    return y.reshape(B, T, d).to(x.dtype)


# -- embeddings ----------------------------------------------------------------

def init_embedding(gen: torch.Generator, cfg: ModelConfig) -> Params:
    dt = cfg.pdtype()
    p: Params = {"embedding": _normal(gen, (cfg.vocab_size, cfg.d_model), dt,
                                      0.02)}
    if not cfg.tie_embeddings:
        p["lm_head"] = _normal(gen, (cfg.d_model, cfg.vocab_size), dt,
                               cfg.d_model ** -0.5)
    return p


def embed_tokens(p: Params, tokens: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    # `F.embedding` (the same rows as indexing), on the table gathered
    # whole under sharding: DTensor's vocab-sharded lookup mis-sizes its
    # mask for batch-sharded tokens, and an indexed gather's backward
    # (`index_put`) has no strategy on some torch versions
    return F.embedding(tokens, replicated(p["embedding"])).to(cfg.dtype())


def unembed(p: Params, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        return promoted_matmul(h, p["embedding"].T.to(cfg.dtype()))
    return promoted_matmul(h, p["lm_head"].to(cfg.dtype()))
