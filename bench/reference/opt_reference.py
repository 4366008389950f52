"""Plain reference of the benchmark's OPT decoder, in float32 PyTorch.

The architecture is OPT as the system under test builds it (arXiv:2205.01068,
with the departures its configuration files list): token embedding; per
layer a pre-LayerNorm self-attention block (q, k, v and o projections
without biases, rotary position embedding on q and k, causal softmax at
scale 1 / sqrt(head_dim)) and a pre-LayerNorm ReLU FFN (up and down
projections without biases), each added to the residual stream; a final
LayerNorm and an untied output projection. No cache, no batching, no
kernel: one sequence at a time, every matrix product in float32 with TF32
off. It imports nothing but torch.

Weights come as the benchmark's dict (see `bench/weights.py`):
{"embedding" [V, d], "lm_head" [d, V], "final_norm" {"scale", "bias"},
"layers": [{"norm1", "wq", "wk", "wv", "wo", "norm2", "w_up" [d, f],
"w_down" [f, d]}]}, in any float dtype; each is cast to float32 where it
is used, a layer at a time.

Served offload decode computes the FFN of every generated position from
the rows of a NeuronPack, which holds a bf16 model's rows as int8 with one
float32 scale per neuron. `pack_rows_int8` works those rows out again from
the weights, and `forward_logits(..., decode_ffn=...)` uses them from the
position where decoding starts, as the served path does.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import torch

LN_EPS = 1e-5


def layer_norm(x: torch.Tensor, p: Dict[str, torch.Tensor]) -> torch.Tensor:
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + LN_EPS) * p["scale"].float() \
        + p["bias"].float()


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x [T, H, hd]: the two halves of each head rotated by position."""
    half = x.shape[-1] // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=x.device) / half))
    ang = positions.float()[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(h: torch.Tensor, lw: Dict, cfg: Dict) -> torch.Tensor:
    T = h.shape[0]
    H, KV = cfg["n_heads"], cfg["n_kv_heads"]
    hd = cfg["d_model"] // H
    pos = torch.arange(T, device=h.device)
    q = rope((h @ lw["wq"].float()).view(T, H, hd), pos, cfg["rope_theta"])
    k = rope((h @ lw["wk"].float()).view(T, KV, hd), pos, cfg["rope_theta"])
    v = (h @ lw["wv"].float()).view(T, KV, hd)
    if KV != H:
        k = k.repeat_interleave(H // KV, dim=1)
        v = v.repeat_interleave(H // KV, dim=1)
    scores = torch.einsum("thd,shd->hts", q, k) * hd ** -0.5
    causal = torch.ones(T, T, dtype=torch.bool, device=h.device).tril()
    probs = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
    out = torch.einsum("hts,shd->thd", probs, v).reshape(T, H * hd)
    return out @ lw["wo"].float()


def ffn(h: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor) -> torch.Tensor:
    return torch.relu(h @ w_up.float()) @ w_down.float()


def pack_rows_int8(w_up: torch.Tensor, w_down: torch.Tensor):
    """The FFN as a pack holds it: per neuron j the row [w_up[:, j] |
    w_down[j]] in float32, scaled by max|row| / 127, rounded to nearest
    and clipped to [-127, 127]; returns the dequantized (up [d, f], down
    [f, d]) in float32."""
    rows = torch.cat([w_up.float().T, w_down.float()], dim=1)     # [f, 2d]
    peak = rows.abs().amax(dim=1)
    scale = torch.where(peak > 0, peak / 127.0, torch.ones_like(peak))
    q = torch.clamp(torch.round(rows / scale[:, None]), -127, 127)
    deq = q * scale[:, None]
    d = w_up.shape[0]
    return deq[:, :d].T.contiguous(), deq[:, d:].contiguous()


def forward_logits(weights: Dict, cfg: Dict, tokens: torch.Tensor,
                   positions_out: Sequence[int],
                   decode_from: Optional[int] = None,
                   decode_ffn: Optional[Callable[[int], tuple]] = None,
                   weight_map: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
                   ) -> torch.Tensor:
    """float32 logits [len(positions_out), V] of one sequence `tokens` [T]
    at the given positions. With `decode_ffn`, layer l's FFN at positions
    >= `decode_from` uses `decode_ffn(l)` -> (w_up, w_down) in place of the
    weights' own. `weight_map` transforms every weight matrix before use
    (the lower-precision control)."""
    wm = weight_map or (lambda w: w.float())
    x = wm(weights["embedding"])[tokens.long()].float()
    for l, lw in enumerate(weights["layers"]):
        lw_m = {k: (wm(v) if k in ("wq", "wk", "wv", "wo") else v)
                for k, v in lw.items()}
        x = x + attention(layer_norm(x, lw["norm1"]), lw_m, cfg)
        h2 = layer_norm(x, lw["norm2"])
        y = ffn(h2, wm(lw["w_up"]), wm(lw["w_down"]))
        if decode_ffn is not None and decode_from is not None \
                and decode_from < x.shape[0]:
            up, down = decode_ffn(l)
            y[decode_from:] = ffn(h2[decode_from:], up, down)
        x = x + y
    idx = torch.as_tensor(list(positions_out), device=x.device, dtype=torch.long)
    hf = layer_norm(x[idx], weights["final_norm"])
    return hf @ wm(weights["lm_head"]).float()


def layer_shares(weights: Dict, cfg: Dict, tokens: torch.Tensor) -> List[float]:
    """Per layer, the share of (token, neuron) pairs whose FFN
    pre-activation is positive, for a batch of sequences [B, T]."""
    out = []
    xs = [weights["embedding"].float()[t.long()] for t in tokens]
    for lw in weights["layers"]:
        act, tot = 0, 0
        for i, x in enumerate(xs):
            x = x + attention(layer_norm(x, lw["norm1"]), lw, cfg)
            h2 = layer_norm(x, lw["norm2"])
            pre = h2 @ lw["w_up"].float()
            act += int((pre > 0).sum())
            tot += pre.numel()
            xs[i] = x + torch.relu(pre) @ lw["w_down"].float()
        out.append(act / tot)
    return out
