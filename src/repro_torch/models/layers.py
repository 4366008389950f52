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

from repro_torch.configs.base import ModelConfig

Params = Dict[str, torch.Tensor]

NEG_INF = -1e30


def _normal(gen: torch.Generator, shape, dtype, std: float) -> torch.Tensor:
    return torch.randn(shape, generator=gen, dtype=dtype,
                       device=gen.device) * std


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

def init_attention(gen: torch.Generator, cfg: ModelConfig) -> Params:
    d, hd, H, KV = cfg.d_model, cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    dt = cfg.pdtype()
    std = d ** -0.5
    p: Params = {
        "wq": _normal(gen, (d, H * hd), dt, std),
        "wk": _normal(gen, (d, KV * hd), dt, std),
        "wv": _normal(gen, (d, KV * hd), dt, std),
        "wo": _normal(gen, (H * hd, d), dt, (H * hd) ** -0.5),
    }
    if cfg.qkv_bias:
        for name, width in (("bq", H * hd), ("bk", KV * hd), ("bv", KV * hd)):
            p[name] = torch.zeros((width,), dtype=dt, device=gen.device)
    return p


def _project_qkv(p: Params, xq: torch.Tensor, xkv: torch.Tensor,
                 cfg: ModelConfig):
    B, T = xq.shape[0], xq.shape[1]
    S = xkv.shape[1]
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = xq @ p["wq"]
    k = xkv @ p["wk"]
    v = xkv @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return (q.reshape(B, T, H, hd), k.reshape(B, S, KV, hd),
            v.reshape(B, S, KV, hd))


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
    B, T, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    G = H // KV
    qg = q.reshape(B, T, KV, G, hd)
    logits = torch.einsum("btkgh,bskh->bkgts", qg, k).float()
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
        return F.silu(x)
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
    return p["embedding"][tokens].to(cfg.dtype())


def unembed(p: Params, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        return h @ p["embedding"].T.to(cfg.dtype())
    return h @ p["lm_head"].to(cfg.dtype())
