"""Transformer building blocks: norms, RoPE, GQA attention, FFN, embeddings.

Plain functions over parameter dicts of tensors, each taking the
ModelConfig, in the layouts of the reference package (`w_up` is [d, d_ff],
`w_down` [d_ff, d], attention projections [d, heads * head_dim]) so that
weights converted from it compare like with like. Attention over a whole
sequence is the plain einsum formulation (`gqa_attend`) up to
`FLASH_SEQ_THRESHOLD` positions and the reference's chunked online softmax
past it (`flash_gqa_attend`, `flash_gqa_attend_triangular`), which never
holds more than one [q_chunk, k_chunk] block of scores. The `init_*`
functions draw from a `torch.Generator` and create their tensors on that
generator's device.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.dtensor import (reduced, replicated,
                                           rows_and_heads, split_last)

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
    # a residual stream of partial sums is reduced first (the norm's scale
    # and bias are sharded)
    xf = reduced(x).float()
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


FLASH_SEQ_THRESHOLD = 2048


def _flash_block(q_i, k_j, v_j, mask, m, l, acc, scale):
    """One KV block of the online softmax, the reference's `kv_step`:
    scores in float32 times `scale`, NEG_INF where `mask` [B, qc, kc] is
    False, the running max, alpha = exp(m - m_new), P set to 0 where
    masked and cast to v's dtype for P·V, the accumulator in float32.
    q_i [B, KV, G, qc, hd], k_j / v_j [B, KV, kc, hd]; m, l [B, KV, G, qc],
    acc [B, KV, G, qc, hd]. Returns the new (m, l, acc)."""
    B, KV, G, qc, hd = q_i.shape
    kc = k_j.shape[2]
    dt = torch.promote_types(q_i.dtype, k_j.dtype)   # as jnp.einsum
    s = (q_i.reshape(B, KV, G * qc, hd).to(dt)
         @ k_j.to(dt).transpose(-1, -2)).view(B, KV, G, qc, kc)
    s = s.float() * scale
    mask = mask[:, None, None]
    s = torch.where(mask, s, NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1))
    alpha = torch.exp(m - m_new)
    pmat = torch.where(mask, torch.exp(s - m_new[..., None]), 0.0)
    l = l * alpha + pmat.sum(dim=-1)
    pv = (pmat.to(v_j.dtype).reshape(B, KV, G * qc, kc) @ v_j)
    acc = acc * alpha[..., None] + pv.view(B, KV, G, qc, hd).float()
    return m_new, l, acc


def _flash_start(B, KV, G, qc, hd, device):
    m = torch.full((B, KV, G, qc), NEG_INF, dtype=torch.float32,
                   device=device)
    l = torch.zeros((B, KV, G, qc), dtype=torch.float32, device=device)
    acc = torch.zeros((B, KV, G, qc, hd), dtype=torch.float32, device=device)
    return m, l, acc


def _flash_out(l, acc, dtype):
    """acc / max(l, 1e-30) in `dtype`, [B, KV, G, qc, hd] -> [B, qc, H*hd]."""
    B, KV, G, qc, hd = acc.shape
    o = (acc / torch.clamp_min(l, 1e-30)[..., None]).to(dtype)
    return o.permute(0, 3, 1, 2, 4).reshape(B, qc, KV * G * hd)


def _chunks(t: torch.Tensor, n: int, size: int) -> torch.Tensor:
    """[B, n * size, KV, (G,) hd] -> [n, B, KV, (G,) size, hd], contiguous:
    each chunk's heads leading its positions, as the block products take
    them."""
    t = t.reshape(t.shape[0], n, size, *t.shape[2:])
    return t.movedim(2, -2).movedim(1, 0).contiguous()


def flash_gqa_attend(
    q: torch.Tensor,                 # [B, T, H, hd]
    k: torch.Tensor,                 # [B, S, KV, hd]
    v: torch.Tensor,
    q_pos: torch.Tensor,             # [B, T]
    k_pos: torch.Tensor,             # [B, S]
    k_valid: Optional[torch.Tensor] = None,   # [B, S] bool
    causal: bool = True,
    window: int = 0,
    q_chunk: int = 1024,
    k_chunk: int = 1024,
) -> torch.Tensor:
    """Online-softmax chunked attention (the reference's flash attention in
    jnp), [B, T, H * hd]: the same function as `gqa_attend` in O(T) memory.
    An outer loop over query chunks, an inner one over every KV chunk;
    each block's mask is built from its own positions and `k_valid`, so no
    [B, T, S] tensor exists. Queries are padded with position 0 and keys
    with position 0 and invalid, as the reference pads. Under sharding each
    rank attends its own rows and KV heads (`rows_and_heads`)."""
    def attend(q, k, v, q_pos, k_pos, k_valid):
        return _flash_gqa_attend(q, k, v, q_pos, k_pos, k_valid, causal,
                                 window, q_chunk, k_chunk)
    return rows_and_heads(attend, q, (q, k, v, q_pos, k_pos, k_valid),
                          (2, 2, 2, None, None, None), k.shape[2], (2,))


def _flash_gqa_attend(q, k, v, q_pos, k_pos, k_valid, causal, window,
                      q_chunk, k_chunk):
    B, T, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    G = H // KV
    q_chunk, k_chunk = min(q_chunk, T), min(k_chunk, S)
    padT, padS = (-T) % q_chunk, (-S) % k_chunk
    if k_valid is None:
        k_valid = torch.ones((B, S), dtype=torch.bool, device=k.device)
    if padT:
        q = F.pad(q, (0, 0, 0, 0, 0, padT))
        q_pos = F.pad(q_pos, (0, padT))
    if padS:
        k = F.pad(k, (0, 0, 0, 0, 0, padS))
        v = F.pad(v, (0, 0, 0, 0, 0, padS))
        k_pos = F.pad(k_pos, (0, padS))
        k_valid = F.pad(k_valid, (0, padS))
    nq, nk = (T + padT) // q_chunk, (S + padS) // k_chunk
    qc = _chunks(q.reshape(B, T + padT, KV, G, hd), nq, q_chunk)
    kc, vc = _chunks(k, nk, k_chunk), _chunks(v, nk, k_chunk)
    qp = q_pos.reshape(B, nq, q_chunk)
    kp = k_pos.reshape(B, nk, k_chunk)
    kval = k_valid.reshape(B, nk, k_chunk)
    scale = hd ** -0.5
    outs = []
    for i in range(nq):
        qp_i = qp[:, i]
        m, l, acc = _flash_start(B, KV, G, q_chunk, hd, q.device)
        for j in range(nk):
            kp_j = kp[:, j]
            mask = kval[:, j][:, None, :]
            if causal:
                mask = mask & (kp_j[:, None, :] <= qp_i[:, :, None])
            if window > 0:
                mask = mask & (qp_i[:, :, None] - kp_j[:, None, :] < window)
            m, l, acc = _flash_block(qc[i], kc[j], vc[j], mask, m, l, acc,
                                     scale)
        outs.append(_flash_out(l, acc, q.dtype))
    return torch.cat(outs, dim=1)[:, :T]


def flash_gqa_attend_triangular(
    q: torch.Tensor,                 # [B, T, H, hd]
    k: torch.Tensor,                 # [B, T, KV, hd] (self-attention: S == T)
    v: torch.Tensor,
    positions: torch.Tensor,         # [B, T] == arange
    window: int = 0,
    chunk: int = 1024,
) -> torch.Tensor:
    """Causal flash attention that skips the KV blocks wholly masked, the
    reference's triangular form: query chunk i visits only KV chunks
    lo..i, lo from the window's horizon. Needs S == T and positions that
    are an arange (self-attention prefill or training); padded positions
    are -1 and never attended. Under sharding as `flash_gqa_attend`."""
    def attend(q, k, v, positions):
        return _flash_gqa_attend_triangular(q, k, v, positions, window,
                                            chunk)
    return rows_and_heads(attend, q, (q, k, v, positions),
                          (2, 2, 2, None), k.shape[2], (2,))


def _flash_gqa_attend_triangular(q, k, v, positions, window, chunk):
    B, T, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    chunk = min(chunk, T)
    pad = (-T) % chunk
    if pad:
        q = F.pad(q, (0, 0, 0, 0, 0, pad))
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        positions = F.pad(positions, (0, pad), value=-1)
    n = (T + pad) // chunk
    qc = _chunks(q.reshape(B, T + pad, KV, G, hd), n, chunk)
    kc, vc = _chunks(k, n, chunk), _chunks(v, n, chunk)
    pc = positions.reshape(B, n, chunk)
    scale = hd ** -0.5
    outs = []
    for i in range(n):
        lo = 0 if window <= 0 else max(0, i - (window - 1) // chunk - 1)
        qp_i = pc[:, i]
        m, l, acc = _flash_start(B, KV, G, chunk, hd, q.device)
        for j in range(lo, i + 1):
            kp_j = pc[:, j]
            mask = ((kp_j[:, None, :] <= qp_i[:, :, None])
                    & (kp_j[:, None, :] >= 0))
            if window > 0:
                mask = mask & (qp_i[:, :, None] - kp_j[:, None, :] < window)
            m, l, acc = _flash_block(qc[i], kc[j], vc[j], mask, m, l, acc,
                                     scale)
        outs.append(_flash_out(l, acc, q.dtype))
    return torch.cat(outs, dim=1)[:, :T]


def attention_forward(p: Params, x: torch.Tensor, positions: torch.Tensor,
                      cfg: ModelConfig, causal: bool = True,
                      window: int = 0, use_rope: bool = True
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Self-attention over a full sequence (train / prefill / encoder).
    Returns (output [B, T, d], roped k, v) so prefill can fill its cache
    (k unroped where `use_rope` is False: a NoPE layer).
    Past `FLASH_SEQ_THRESHOLD` positions it attends through the chunked
    flash form, triangular when causal and `cfg.flash_triangular`, with
    `cfg.flash_q_chunk` / `flash_k_chunk`, as the reference routes."""
    q, k, v = _project_qkv(p, x, x, cfg)
    if use_rope:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    if x.shape[1] > FLASH_SEQ_THRESHOLD:
        if causal and cfg.flash_triangular:
            out = flash_gqa_attend_triangular(q, k, v, positions,
                                              window=window,
                                              chunk=cfg.flash_q_chunk)
        else:
            out = flash_gqa_attend(q, k, v, positions, positions,
                                   causal=causal, window=window,
                                   q_chunk=cfg.flash_q_chunk,
                                   k_chunk=cfg.flash_k_chunk)
    else:
        out = gqa_attend(q, k, v, positions, positions, causal=causal,
                         window=window)
    return out @ p["wo"], k, v


def cross_attention_forward(p: Params, x: torch.Tensor,
                            memory_k: torch.Tensor, memory_v: torch.Tensor,
                            cfg: ModelConfig) -> torch.Tensor:
    """Attention of x [B, T, d] over the encoder memory's K/V [B, S, KV, hd]
    (from `project_memory_kv`): no rope (every position 0), not causal;
    the chunked flash form when T or S passes `FLASH_SEQ_THRESHOLD`."""
    B, T = x.shape[0], x.shape[1]
    q = split_last(x @ p["wq"], cfg.n_heads)
    S = memory_k.shape[1]
    zeros_q = torch.zeros((B, T), dtype=torch.int32, device=x.device)
    zeros_k = torch.zeros((B, S), dtype=torch.int32, device=x.device)
    if T > FLASH_SEQ_THRESHOLD or S > FLASH_SEQ_THRESHOLD:
        out = flash_gqa_attend(q, memory_k, memory_v, zeros_q, zeros_k,
                               causal=False, q_chunk=cfg.flash_q_chunk,
                               k_chunk=cfg.flash_k_chunk)
    else:
        out = gqa_attend(q, memory_k, memory_v, zeros_q, zeros_k,
                         causal=False)
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
