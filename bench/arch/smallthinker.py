"""SmallThinker as the port builds it: its configuration, weights and plain
reference glued to the harness, and the shape counts the readers take.

The configuration file holds the model's config.json keys as published
(`num_hidden_layers`, `hidden_size`, `head_dim`, `sliding_window_layout`,
`rope_layout`, `moe_num_primary_experts`, ...; see
`bench/reference/smallthinker_reference.py` for the layer equations). A
layer with `sliding_window_layout` 1 attends a window of
`sliding_window_size` positions with RoPE, one with 0 attends causally in
full without positional encoding; every layer is a MoE of `E` ReGLU
experts of width `f`, `K` of them a token, routed from the attention's
input.

The weights are 43 GB in bf16, too much to hold twice on one card, so
`make_weights` returns a recipe and no tensors: each tensor is drawn on
the device from a generator of its own, seeded from (seed, layer, name),
so a draw depends on nothing drawn before it. `program_params`
materialises the program's tree once; the reference draws each layer
again as it reaches it. Like the reference, this module imports nothing
of the program: the harness hands `model_config` the program's config
module.
"""
from __future__ import annotations

import hashlib
from typing import Dict, List, Tuple

import torch

from reference.smallthinker_reference import forward_logits

__all__ = ["model_config", "make_weights", "program_params", "forward_logits",
           "decode_row_flops", "decode_row_ffn_flops", "ffn_flops",
           "prefill_flops", "paged_attention", "swa_attention", "expert_bytes",
           "window_layers", "period", "Recipe"]

ELEM = {"bfloat16": 2, "float32": 4}     # bytes of an element


def _dims(cfg: Dict):
    return (cfg["num_hidden_layers"], cfg["hidden_size"],
            cfg["num_attention_heads"], cfg["num_key_value_heads"],
            cfg["head_dim"], cfg["moe_num_primary_experts"],
            cfg["moe_num_active_primary_experts"], cfg["moe_ffn_hidden_size"],
            cfg["vocab_size"])


def _kind(cfg: Dict, l: int) -> str:
    """The port's attention kind of layer l: "window" (windowed, RoPE) or
    "nope" (full, no RoPE); the other two combinations are not in this
    family."""
    pair = (cfg["sliding_window_layout"][l], cfg["rope_layout"][l])
    kinds = {(1, 1): "window", (0, 0): "nope"}
    if pair not in kinds:
        raise ValueError(f"layer {l}: sliding window {pair[0]} with rope "
                         f"{pair[1]} is not a SmallThinker layer")
    return kinds[pair]


def window_layers(cfg: Dict) -> List[bool]:
    """Per layer, whether it attends through a window (a ring)."""
    return [_kind(cfg, l) == "window" for l in range(cfg["num_hidden_layers"])]


def period(cfg: Dict) -> int:
    """The layout's period: the program stacks its layers in groups of it."""
    kinds = [_kind(cfg, l) for l in range(cfg["num_hidden_layers"])]
    L = len(kinds)
    return next(P for P in range(1, L + 1)
                if L % P == 0 and all(kinds[i] == kinds[i % P] for i in range(L)))


# -- the program's side -------------------------------------------------------------

def model_config(cfg: Dict, max_len: int, configs):
    """The port's `ModelConfig` (`configs` is `repro_torch.configs.base`)."""
    L, d, H, KV, hd, E, K, f, V = _dims(cfg)
    if not (cfg["moe_primary_router_apply_softmax"] and cfg["norm_topk_prob"]):
        raise ValueError("the port routes by a renormalised top-k softmax")
    return configs.ModelConfig(
        arch_id=cfg["name"], family="moe", source=cfg["source"],
        n_layers=L, d_model=d, n_heads=H, n_kv_heads=KV, head_width=hd,
        d_ff=0, vocab_size=V, activation="relu", norm="rmsnorm",
        tie_embeddings=cfg["tie_word_embeddings"],
        rope_theta=float(cfg["rope_theta"]), max_seq_len=max_len,
        sliding_window=cfg["sliding_window_size"],
        attn_layout=tuple(_kind(cfg, l) for l in range(L)),
        flash_triangular=True,
        moe=configs.MoEConfig(n_experts=E, top_k=K, d_ff_expert=f,
                              activation="relu", router_input="pre_attention",
                              dropless=True),
        param_dtype=cfg["dtype"], compute_dtype=cfg["dtype"], remat=False)


class Recipe:
    """The weights of (configuration, seed) on a device, drawn when asked.
    Each tensor comes from its own generator (`seed_of`); matrices are
    N(0, 1 / fan_in), but the router at `init["router_scale"]` times that
    std and the residual branches' output projections (`wo`, `w_down`) at
    `init["out_scale"]` times it; the embedding N(0, embedding_std^2), norm
    scales 1 + N(0, norm_std^2); all rounded to the configuration's dtype
    once drawn. A sharper router and quieter branches keep a routing near
    tie, which bf16 and float32 break differently, from moving every layer
    after it, so the check parts sound runs from the control. No sparsity is planted: a resident cell computes every
    neuron of the routed experts."""

    def __init__(self, cfg: Dict, seed: int, device):
        self.cfg, self.seed, self.device = cfg, int(seed), torch.device(device)
        self.dtype = getattr(torch, cfg["dtype"])

    def seed_of(self, layer: int, name: str) -> int:
        h = hashlib.sha256(
            f"{self.cfg['name']}|{self.seed}|{layer}|{name}".encode()).digest()
        return int.from_bytes(h[:8], "little") >> 1

    def _draw(self, layer: int, name: str, shape, std: float,
              mean: float = 0.0) -> torch.Tensor:
        g = torch.Generator(device=self.device).manual_seed(
            self.seed_of(layer, name))
        t = torch.randn(shape, generator=g, device=self.device,
                        dtype=torch.float32)
        return (t.mul_(std).add_(mean)).to(self.dtype)

    def shapes(self) -> Dict[str, Tuple[tuple, float, float]]:
        """Each layer tensor's (shape, std, mean)."""
        L, d, H, KV, hd, E, K, f, V = _dims(self.cfg)
        init = self.cfg["init"]
        ns = init["norm_std"]
        rs, os_ = init["router_scale"], init["out_scale"]
        return {"norm1": ((d,), ns, 1.0), "router": ((d, E), rs * d ** -0.5, 0.0),
                "wq": ((d, H * hd), d ** -0.5, 0.0),
                "wk": ((d, KV * hd), d ** -0.5, 0.0),
                "wv": ((d, KV * hd), d ** -0.5, 0.0),
                "wo": ((H * hd, d), os_ * (H * hd) ** -0.5, 0.0),
                "norm2": ((d,), ns, 1.0),
                "w_gate": ((E, d, f), d ** -0.5, 0.0),
                "w_up": ((E, d, f), d ** -0.5, 0.0),
                "w_down": ((E, f, d), os_ * f ** -0.5, 0.0)}

    def layer(self, l: int) -> Dict[str, torch.Tensor]:
        return {n: self._draw(l, n, *spec) for n, spec in self.shapes().items()}

    def tensor(self, name: str) -> torch.Tensor:
        L, d, H, KV, hd, E, K, f, V = _dims(self.cfg)
        init = self.cfg["init"]
        spec = {"embedding": ((V, d), init["embedding_std"], 0.0),
                "lm_head": ((d, V), d ** -0.5, 0.0),
                "final_norm": ((d,), init["norm_std"], 1.0)}[name]
        return self._draw(-1, name, *spec)


def make_weights(cfg: Dict, seed: int, device) -> Tuple[Recipe, Dict]:
    """(the recipe, a report): nothing is drawn here."""
    return Recipe(cfg, seed, device), {"target": None}


def program_params(recipe: Recipe) -> Dict:
    """The program's parameter tree, drawn once: its stack in groups of the
    layout's period, sublayer j of group g being layer g * period + j."""
    P = period(recipe.cfg)
    G = recipe.cfg["num_hidden_layers"] // P
    stack = []
    for g in range(G):
        group = {}
        for j in range(P):
            w = recipe.layer(g * P + j)
            group[f"sub_{j}"] = {
                "norm1": {"scale": w["norm1"]},
                "mixer": {k: w[k] for k in ("wq", "wk", "wv", "wo")},
                "norm2": {"scale": w["norm2"]},
                "ffn": {k: w[k] for k in ("router", "w_gate", "w_up",
                                          "w_down")}}
        stack.append(group)
    return {"embed": {"embedding": recipe.tensor("embedding"),
                      "lm_head": recipe.tensor("lm_head")},
            "stack": stack,
            "final_norm": {"scale": recipe.tensor("final_norm")}}


# -- shape counts the readers take ----------------------------------------------------

def _attn_flops(cfg: Dict, c: int, windowed: bool) -> int:
    """Scores and weighted values of one query over its positions: 4 H hd
    a position, a window layer at min(c, window) positions."""
    H, hd = cfg["num_attention_heads"], cfg["head_dim"]
    n = min(c, cfg["sliding_window_size"]) if windowed else c
    return 4 * H * hd * n


def _proj_flops(cfg: Dict) -> int:
    """One row's q, k, v and o projections and router: 2 d (H hd + 2 KV hd)
    + 2 H hd d + 2 d E."""
    L, d, H, KV, hd, E, K, f, V = _dims(cfg)
    return 2 * d * (H * hd + 2 * KV * hd) + 2 * H * hd * d + 2 * d * E


def decode_row_flops(cfg: Dict, c: int) -> int:
    """FLOPs of one decoded row that attends `c` positions, without its
    experts: a layer `_proj_flops` + 4 H hd c, window layers at
    min(c, window); the LM head 2 d V."""
    d, V = cfg["hidden_size"], cfg["vocab_size"]
    return sum(_proj_flops(cfg) + _attn_flops(cfg, c, w)
               for w in window_layers(cfg)) + 2 * d * V


def ffn_flops(cfg: Dict, u: int) -> int:
    """FLOPs of `u` expert neurons of one layer for one row: gate, up and
    down products, 3 x 2 d a neuron."""
    return 6 * cfg["hidden_size"] * u


def decode_row_ffn_flops(cfg: Dict) -> int:
    """FLOPs of one decoded row's experts: L layers x K routed experts x
    their f neurons."""
    L, d, H, KV, hd, E, K, f, V = _dims(cfg)
    return L * ffn_flops(cfg, K * f)


def prefill_flops(cfg: Dict, T: int) -> int:
    """FLOPs of a prefill of `T` tokens: a layer T (`_proj_flops` + K
    experts) + the attention of every query over the positions it sees
    (sum over t of 4 H hd min(t + 1, window) on a window layer, 4 H hd
    T (T + 1) / 2 on a full one), and the LM head at the last position."""
    L, d, H, KV, hd, E, K, f, V = _dims(cfg)
    W = cfg["sliding_window_size"]
    seen_full = T * (T + 1) // 2
    m = min(T, W)
    seen_window = m * (m + 1) // 2 + (T - m) * W
    total = 0
    for w in window_layers(cfg):
        total += T * (_proj_flops(cfg) + ffn_flops(cfg, K * f))
        total += 4 * H * hd * (seen_window if w else seen_full)
    return total + 2 * d * V


def paged_attention(cfg: Dict) -> Dict[str, int]:
    """The paged decode attention a step: one call a full layer (`calls`),
    its query heads and head width, and the bytes of K and V of one
    position (the window layers attend rings, not pages)."""
    hd = cfg["head_dim"]
    return {"calls": window_layers(cfg).count(False),
            "heads": cfg["num_attention_heads"], "head_dim": hd,
            "kv_bytes": 2 * cfg["num_key_value_heads"] * hd * ELEM[cfg["dtype"]]}


def swa_attention(cfg: Dict) -> Dict[str, int]:
    """The ring decode attention a step: one call a window layer, the
    window, query heads, head width, the bytes of K and V of one position
    and of an element of the query and output (the model's dtype)."""
    hd = cfg["head_dim"]
    e = ELEM[cfg["dtype"]]
    return {"calls": window_layers(cfg).count(True),
            "window": cfg["sliding_window_size"],
            "heads": cfg["num_attention_heads"], "head_dim": hd,
            "kv_bytes": 2 * cfg["num_key_value_heads"] * hd * e, "elem": e}


def expert_bytes(cfg: Dict) -> int:
    """Bytes of one expert's three matrices: 3 d f elements."""
    return 3 * cfg["hidden_size"] * cfg["moe_ffn_hidden_size"] * ELEM[cfg["dtype"]]
