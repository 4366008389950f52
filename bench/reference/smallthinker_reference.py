"""Plain reference of SmallThinker-21BA3B, in float32 PyTorch.

The layer equations (huggingface.co/PowerInfer/SmallThinker-21BA3B-Instruct,
config.json, with the family's description where the config says nothing).
Layer l, residual x, every product a row at a time:

    a = RMSNorm1(x)
    r = softmax(a W_r) over the experts; S = the top_k largest (ties to the
        lower index); w_e = r_e / sum of r over S      (router before the
        attention, on its input)
    q = a W_q (H heads of hd), k = a W_k, v = a W_v (KV heads of hd);
        query head h reads KV head h // (H / KV)
    sliding_window_layout[l] = 1: RoPE on q and k (rope_layout[l] = 1, the
        two halves of a head rotated, theta rope_theta), and a query at p
        sees the keys in (p - sliding_window_size, p]
    sliding_window_layout[l] = 0: no RoPE (rope_layout[l] = 0), causal
        over [0, p]
    x = x + softmax(q k^T / sqrt(hd)) v W_o
    b = RMSNorm2(x)
    x = x + sum over e in S of w_e W_down,e(relu(b W_gate,e) * (b W_up,e))

and at the end logits = RMSNorm_f(x) W_head. RMSNorm(x) = x / sqrt(mean(x^2)
+ rms_norm_eps) * scale.

Departures, each the configuration file's `assumed`: the router reads the
attention's input (the family's "router placed before attention"); the
experts are ReGLU; the family's "secondary experts" are not built (the
config does not size them); no QK norm and no projection biases (the config
names none).

One sequence at a time, no cache, no batching, no kernel: attention over
blocks of queries (each block against the keys it can see, so 10,240
positions fit), each expert's products over the rows routed to it alone,
the routing from the reference's own float32 activations. It imports
nothing but torch. Every matrix product in float32; the caller turns TF32
off.

Weights come from a `recipe` object (`bench/arch/smallthinker.py`) that
draws each tensor when asked: `recipe.tensor(name)` for "embedding" [V,
d], "lm_head" [d, V] and "final_norm" [d], `recipe.layer(l)` for layer l's
dict {"norm1" [d], "router" [d, E], "wq" [d, H hd], "wk", "wv" [d, KV hd],
"wo" [H hd, d], "norm2" [d], "w_gate", "w_up" [E, d, f], "w_down" [E, f,
d]}, in the configuration's dtype. A layer is drawn as the forward reaches
it, cast to float32 and dropped after it.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import torch

Q_BLOCK = 1024      # queries a block of the attention


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) \
        * scale.float()


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x [T, N, hd]: the two halves of each head rotated by position."""
    half = x.shape[-1] // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=x.device) / half))
    ang = positions.float()[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def route(a: torch.Tensor, router: torch.Tensor, k: int):
    """a [T, d] -> (weights [T, k], experts [T, k]): the top k of the
    softmax, ties to the lower index, renormalised."""
    probs = torch.softmax(a @ router, dim=-1)
    w, sel = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, sel = w[:, :k], sel[:, :k]
    return w / w.sum(dim=-1, keepdim=True), sel


def attention(a: torch.Tensor, lw: Dict, cfg: Dict, windowed: bool,
              roped: bool) -> torch.Tensor:
    T = a.shape[0]
    H, KV, hd = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                 cfg["head_dim"])
    G, W = H // KV, cfg["sliding_window_size"]
    pos = torch.arange(T, device=a.device)
    q = (a @ lw["wq"]).view(T, KV, G, hd)
    k = (a @ lw["wk"]).view(T, KV, hd)
    v = (a @ lw["wv"]).view(T, KV, hd)
    if roped:
        q = rope(q.reshape(T, H, hd), pos, cfg["rope_theta"]).view(T, KV, G, hd)
        k = rope(k, pos, cfg["rope_theta"])
    out = torch.empty(T, H * hd, device=a.device)
    for i0 in range(0, T, Q_BLOCK):
        i1 = min(i0 + Q_BLOCK, T)
        j0 = max(0, i0 - W + 1) if windowed else 0
        qp, kp = pos[i0:i1, None], pos[None, j0:i1]
        seen = kp <= qp
        if windowed:
            seen &= qp - kp < W
        s = torch.einsum("tkgd,skd->kgts", q[i0:i1], k[j0:i1]) * hd ** -0.5
        p = torch.softmax(s.masked_fill(~seen, float("-inf")), dim=-1)
        out[i0:i1] = torch.einsum("kgts,skd->tkgd", p, v[j0:i1]).reshape(
            i1 - i0, H * hd)
    return out @ lw["wo"]


def experts(b: torch.Tensor, w: torch.Tensor, sel: torch.Tensor,
            lw: Dict) -> torch.Tensor:
    """sum over each row's routed experts of w_e * W_down,e(relu(b W_gate,e)
    * (b W_up,e)), each expert on its own rows."""
    T, K = sel.shape
    flat = sel.reshape(-1)
    order = torch.argsort(flat, stable=True)
    counts = torch.bincount(flat, minlength=lw["w_gate"].shape[0]).tolist()
    y_pairs = torch.zeros(T * K, b.shape[1], device=b.device)
    start = 0
    for e, n in enumerate(counts):
        if n:
            pairs = order[start:start + n]
            be = b[pairs // K]
            h = torch.relu(be @ lw["w_gate"][e]) * (be @ lw["w_up"][e])
            y_pairs[pairs] = h @ lw["w_down"][e]
        start += n
    return (y_pairs.view(T, K, -1) * w[..., None]).sum(dim=1)


def forward_logits(recipe, cfg: Dict, tokens: torch.Tensor,
                   positions_out: Sequence[int],
                   decode_from: Optional[int] = None,
                   decode_ffn: Optional[Callable] = None,
                   weight_map: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
                   ) -> torch.Tensor:
    """float32 logits [len(positions_out), V] of one sequence `tokens` [T]
    at the given positions. `weight_map` transforms every weight matrix
    (norm scales aside) before use (the lower-precision control). The
    served path decodes with the resident weights, so `decode_from` and
    `decode_ffn` (an offload cell's pack rows) must be None."""
    if decode_ffn is not None:
        raise ValueError("SmallThinker is served resident: no pack rows")
    wm = weight_map or (lambda t: t.float())
    eps = cfg["rms_norm_eps"]
    K = cfg["moe_num_active_primary_experts"]
    x = wm(recipe.tensor("embedding"))[tokens.long()].float()
    for l in range(cfg["num_hidden_layers"]):
        lw = {n: (t.float() if n.startswith("norm") else wm(t))
              for n, t in recipe.layer(l).items()}
        a = rms_norm(x, lw["norm1"], eps)
        w, sel = route(a, lw["router"], K)
        x = x + attention(a, lw, cfg, cfg["sliding_window_layout"][l] == 1,
                          cfg["rope_layout"][l] == 1)
        x = x + experts(rms_norm(x, lw["norm2"], eps), w, sel, lw)
        del lw
    idx = torch.as_tensor(list(positions_out), device=x.device, dtype=torch.long)
    hf = rms_norm(x[idx], recipe.tensor("final_norm"), eps)
    return hf @ wm(recipe.tensor("lm_head"))
