"""OPT as the port builds it: what the harness, the check and the readers
need to know of the model's shape, in one place.

A configuration file names its architecture (`"arch": "opt"`), and the
harness loads `bench/arch/<arch>.py`. This one glues the benchmark's OPT
weights (`bench/weights.py`) and its plain reference
(`bench/reference/opt_reference.py`) to the harness, and gives the shape
counts that the per-layer readers take: a dense decoder of `n_layers`
pre-LayerNorm blocks, attention with `n_heads` query and `n_kv_heads` KV
heads of `head_dim`, a ReLU FFN of `d_ff` neurons without biases, and an
untied LM head. Like the reference, it imports nothing of the program: the
harness hands `model_config` the program's config module.

Offload cells also take `pack_rows`, `ffn_fingerprint` and `pack_seed`;
a module whose cells are all resident may leave them out.
"""
from __future__ import annotations

from typing import Dict, List

from reference.opt_reference import forward_logits, pack_rows_int8
from weights import ffn_fingerprint, make_weights, seed_for

__all__ = ["model_config", "make_weights", "program_params", "forward_logits",
           "pack_rows", "ffn_fingerprint", "pack_seed", "ffn_neurons",
           "decode_row_flops", "decode_row_ffn_flops", "ffn_flops",
           "prefill_flops", "paged_attention"]

ELEM = {"bfloat16": 2, "float32": 4}     # bytes of an element of the KV arena


# -- the program's side -------------------------------------------------------------

def model_config(cfg: Dict, max_len: int, configs):
    """The port's `ModelConfig` (`configs` is `repro_torch.configs.base`)."""
    return configs.ModelConfig(
        arch_id=cfg["name"], family="dense", source=cfg["source"],
        n_layers=cfg["n_layers"], d_model=cfg["d_model"],
        n_heads=cfg["n_heads"], n_kv_heads=cfg["n_kv_heads"],
        d_ff=cfg["d_ff"], vocab_size=cfg["vocab_size"],
        activation=cfg["activation"], norm=cfg["norm"],
        rope_theta=cfg["rope_theta"], max_seq_len=max_len,
        param_dtype=cfg["dtype"], compute_dtype=cfg["dtype"], remat=False)


def program_params(weights: Dict) -> Dict:
    """The program's parameter tree over copies of the benchmark's
    weights (the program never holds the tensors the reference reads)."""
    c = lambda t: t.clone()                                     # noqa: E731
    norm = lambda p: {"scale": c(p["scale"]), "bias": c(p["bias"])}  # noqa
    stack = [{"sub_0": {
        "norm1": norm(lw["norm1"]),
        "mixer": {k: c(lw[k]) for k in ("wq", "wk", "wv", "wo")},
        "norm2": norm(lw["norm2"]),
        "ffn": {"w_up": c(lw["w_up"]), "w_down": c(lw["w_down"])}}}
        for lw in weights["layers"]]
    return {"embed": {"embedding": c(weights["embedding"]),
                      "lm_head": c(weights["lm_head"])},
            "stack": stack, "final_norm": norm(weights["final_norm"])}


def pack_rows(weights: Dict) -> List[tuple]:
    """Per layer, the FFN as the int8 pack holds it, dequantized: what
    `forward_logits(..., decode_ffn=rows.__getitem__)` decodes with."""
    return [pack_rows_int8(lw["w_up"], lw["w_down"]) for lw in weights["layers"]]


def pack_seed(cfg: Dict, seed: int) -> int:
    """The seed of the pack builder's calibration tokens (the weights take
    streams 0 and 1 of the run's seed)."""
    return seed_for(cfg, seed, 2)


# -- shape counts the readers take ----------------------------------------------------

def ffn_neurons(cfg: Dict) -> List[int]:
    """Per layer, the FFN neurons whose masks the offload runtime sees."""
    return [cfg["d_ff"]] * cfg["n_layers"]


def decode_row_flops(cfg: Dict, c: int) -> int:
    """FLOPs of one decoded row that attends `c` positions, without its FFN:
    a layer 8 d^2 for q, k, v and o and 4 d c for the scores and the
    weighted values (KV heads = heads); the LM head 2 d V."""
    d, L, V = cfg["d_model"], cfg["n_layers"], cfg["vocab_size"]
    return L * (8 * d * d + 4 * d * c) + 2 * d * V


def ffn_flops(cfg: Dict, u: int) -> int:
    """FLOPs of `u` FFN neurons of one layer for one row (up and down)."""
    return 4 * cfg["d_model"] * u


def decode_row_ffn_flops(cfg: Dict) -> int:
    """FLOPs of one decoded row's FFN in resident decode: every neuron of
    every layer."""
    return cfg["n_layers"] * ffn_flops(cfg, cfg["d_ff"])


def prefill_flops(cfg: Dict, T: int) -> int:
    """FLOPs of a prefill of `T` tokens: a layer 8 d^2 T + 2 d T^2 (causal)
    + 4 d d_ff T, and the LM head at the last position."""
    d, f, L, V = cfg["d_model"], cfg["d_ff"], cfg["n_layers"], cfg["vocab_size"]
    return L * (8 * d * d * T + 2 * d * T * T + 4 * d * f * T) + 2 * d * V


def paged_attention(cfg: Dict) -> Dict[str, int]:
    """The paged decode attention a step: one call a layer (`calls`), its
    query heads and head width, and the bytes of K and V of one position."""
    hd = cfg["head_dim"]
    return {"calls": cfg["n_layers"], "heads": cfg["n_heads"], "head_dim": hd,
            "kv_bytes": 2 * cfg["n_kv_heads"] * hd * ELEM[cfg["dtype"]]}
