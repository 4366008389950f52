"""Decoder stack: attention + dense FFN layers, run as a Python loop.

The reference scans its stack with `lax.scan` over parameters stacked
[G, ...] along a group axis (G = n_layers / period). The port keeps the
same grouping but holds it as a list: `stack[g]` is group g's dict
{"sub_j": sublayer params}, and caches mirror it (`cache[g]["sub_j"]` is a
`KVCache`). For the dense decoder-only models this slice serves, the period
is 1, so group g is layer g.

Only attention mixers and dense FFNs are ported; SSM and MoE sublayers, and
the predictor-driven `serve_sparse` decode, raise ValueError.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.kvcache import (KVCache, attend_full_cache,
                                        init_kv_cache, kv_write, kv_write_rows)
from repro_torch.models.layers import (_project_qkv, apply_norm,
                                       attention_forward, ffn_forward,
                                       init_attention, init_ffn, init_norm,
                                       rope)

Params = Dict[str, Any]


def stack_period(cfg: ModelConfig) -> int:
    kinds, ffns = cfg.layer_kinds(), cfg.ffn_kinds()
    L = cfg.n_layers
    for P in range(1, L + 1):
        if L % P:
            continue
        if all(kinds[i] == kinds[i % P] for i in range(L)) and \
           all(ffns[i] == ffns[i % P] for i in range(L)):
            return P
    return L


def check_supported(cfg: ModelConfig) -> None:
    """Raise ValueError for configurations this slice does not serve."""
    kinds, ffns = set(cfg.layer_kinds()), set(cfg.ffn_kinds())
    if cfg.is_encdec or cfg.family == "vlm":
        raise ValueError(f"{cfg.arch_id}: encoder-decoder and VLM models are "
                         f"not ported to PyTorch yet")
    if kinds != {"attn"}:
        raise ValueError(f"{cfg.arch_id}: mixer kinds {sorted(kinds)} — only "
                         f"attention sublayers are ported (SSM comes later)")
    if not ffns <= {"dense", "none"}:
        raise ValueError(f"{cfg.arch_id}: FFN kinds {sorted(ffns)} — only "
                         f"dense FFNs are ported (MoE comes later)")
    if cfg.serve_sparse:
        raise ValueError("serve_sparse (predictor segment top-k decode) is "
                         "not ported to PyTorch yet")


# -- init ---------------------------------------------------------------------

def _init_sublayer(gen: torch.Generator, cfg: ModelConfig, ffn: str) -> Params:
    p: Params = {"norm1": init_norm(cfg, gen.device),
                 "mixer": init_attention(gen, cfg)}
    if ffn == "dense":
        p["norm2"] = init_norm(cfg, gen.device)
        p["ffn"] = init_ffn(gen, cfg)
    return p


def init_stack(gen: torch.Generator, cfg: ModelConfig) -> List[Params]:
    check_supported(cfg)
    P = stack_period(cfg)
    G = cfg.n_layers // P
    ffns = cfg.ffn_kinds()
    return [{f"sub_{j}": _init_sublayer(gen, cfg, ffns[j]) for j in range(P)}
            for _ in range(G)]


# -- full-sequence forward ------------------------------------------------------

class StackOutput(NamedTuple):
    x: torch.Tensor
    aux_loss: torch.Tensor                     # scalar (0: no MoE ported)
    ffn_pre_act: Optional[torch.Tensor]        # [L_dense, B, T, d_ff] if captured
    ffn_inputs: Optional[torch.Tensor] = None  # [L_dense, B, T, d_model] if captured


def stack_forward(stack: List[Params], x: torch.Tensor,
                  positions: torch.Tensor, cfg: ModelConfig, window: int = 0,
                  capture_activations: bool = False) -> StackOutput:
    P = stack_period(cfg)
    ffns = cfg.ffn_kinds()
    captures: List[torch.Tensor] = []
    captures_h: List[torch.Tensor] = []
    h = x
    for group, j in ((g, j) for g in stack for j in range(P)):
        sp, ffn = group[f"sub_{j}"], ffns[j]
        normed = apply_norm(sp["norm1"], h, cfg)
        mix, _, _ = attention_forward(sp["mixer"], normed, positions, cfg,
                                      window=window)
        h = h + mix
        if ffn == "dense":
            normed2 = apply_norm(sp["norm2"], h, cfg)
            y, pre = ffn_forward(sp["ffn"], normed2, cfg,
                                 capture=capture_activations)
            if capture_activations:
                captures.append(pre)
                captures_h.append(normed2)
            h = h + y
    pre_act = ffn_inputs = None
    if capture_activations and captures:
        pre_act = torch.stack(captures)
        ffn_inputs = torch.stack(captures_h)
    return StackOutput(x=h, aux_loss=torch.zeros((), device=x.device),
                       ffn_pre_act=pre_act, ffn_inputs=ffn_inputs)


# -- caches ----------------------------------------------------------------------

def init_stack_cache(cfg: ModelConfig, batch: int, max_len: int, device,
                     swa: bool = False, dtype=None) -> List[Params]:
    """Per group, {"sub_j": KVCache [batch, max_len, KV, hd]}."""
    if swa:
        raise NotImplementedError(
            "sliding-window (swa) caches are not ported to PyTorch yet")
    check_supported(cfg)
    P = stack_period(cfg)
    G = cfg.n_layers // P
    return [{f"sub_{j}": init_kv_cache(batch, max_len, cfg, device, dtype)
             for j in range(P)} for _ in range(G)]


# -- prefill ----------------------------------------------------------------------

def stack_prefill(stack: List[Params], x: torch.Tensor,
                  positions: torch.Tensor, cache: List[Params],
                  cfg: ModelConfig, window: int = 0
                  ) -> Tuple[torch.Tensor, List[Params]]:
    """Dense prefill over the prompt; fills `cache` in place from slot 0."""
    P = stack_period(cfg)
    ffns = cfg.ffn_kinds()
    h = x
    for group, group_cache, j in ((g, c, j) for g, c in zip(stack, cache)
                                  for j in range(P)):
        sp, ffn = group[f"sub_{j}"], ffns[j]
        normed = apply_norm(sp["norm1"], h, cfg)
        mix, k, v = attention_forward(sp["mixer"], normed, positions, cfg,
                                      window=window)
        kv_write(group_cache[f"sub_{j}"], k, v, 0)
        h = h + mix
        if ffn == "dense":
            y, _ = ffn_forward(sp["ffn"], apply_norm(sp["norm2"], h, cfg), cfg)
            h = h + y
    return h, cache


# -- single-token decode -----------------------------------------------------------

def _decode_positions(position, B: int, device) -> torch.Tensor:
    """[B, 1] decode positions from either a shared scalar or a per-slot [B]
    vector (the continuous-batching server: every KV-cache slot sits at its
    own sequence position)."""
    pos = torch.as_tensor(position, device=device).long()
    if pos.ndim == 1:
        return pos[:, None]
    return pos.reshape(1, 1).expand(B, 1)


def _mixer_decode(sp: Params, cj: KVCache, h: torch.Tensor,
                  pos_arr: torch.Tensor, position, cfg: ModelConfig
                  ) -> Tuple[torch.Tensor, KVCache]:
    """One attention sublayer for a single decode token: (mix [B,1,d], cache).

    `position` is a shared scalar or a per-slot [B] vector; the cache write
    picks the matching (slice vs per-row scatter) variant."""
    if not isinstance(cj, KVCache):
        raise ValueError(f"unsupported cache type {type(cj).__name__}: only "
                         f"the contiguous float KVCache is ported")
    normed = apply_norm(sp["norm1"], h, cfg)
    q, k, v = _project_qkv(sp["mixer"], normed, normed, cfg)
    q = rope(q, pos_arr, cfg.rope_theta)
    k = rope(k, pos_arr, cfg.rope_theta)
    if torch.as_tensor(position).ndim == 1:
        cj = kv_write_rows(cj, k, v, pos_arr[:, 0])
    else:
        cj = kv_write(cj, k, v, position)
    mix = attend_full_cache(q, cj, pos_arr)
    return mix @ sp["mixer"]["wo"], cj


FFNOverride = Callable[[int, torch.Tensor], torch.Tensor]


def stack_decode_step_layerwise(
    param_groups: List[Params],
    x: torch.Tensor,            # [B, 1, d]
    position,                   # scalar (shared) or [B] per-slot positions
    cache_groups: List[Params],
    cfg: ModelConfig,
    ffn_override: Optional[FFNOverride] = None,
) -> Tuple[torch.Tensor, List[Params]]:
    """One decode step over every layer, on the host loop.

    `ffn_override(dense_layer_idx, normed2 [B,1,d]) -> y [B,1,d]` intercepts
    every dense-FFN sublayer — the offload serving path computes those from
    flash bundle payloads instead of the resident weights.
    `dense_layer_idx` counts dense FFN sublayers in (group, sublayer) order,
    the same order `stack_forward(capture_activations=True)` stacks
    `ffn_pre_act`, so calibration traces and serving agree on layer ids.
    Caches are updated in place."""
    B = x.shape[0]
    pos_arr = _decode_positions(position, B, x.device)
    h = x
    dense_idx = 0
    P = stack_period(cfg)
    ffns = cfg.ffn_kinds()
    for group_params, group_cache in zip(param_groups, cache_groups):
        for j in range(P):
            sp = group_params[f"sub_{j}"]
            mix, group_cache[f"sub_{j}"] = _mixer_decode(
                sp, group_cache[f"sub_{j}"], h, pos_arr, position, cfg)
            h = h + mix
            if ffns[j] == "dense":
                normed2 = apply_norm(sp["norm2"], h, cfg)
                if ffn_override is not None:
                    y2 = ffn_override(dense_idx, normed2)
                else:
                    y2, _ = ffn_forward(sp["ffn"], normed2, cfg)
                dense_idx += 1
                h = h + y2
    return h, cache_groups


def stack_decode_step(stack: List[Params], x: torch.Tensor, position,
                      cache: List[Params], cfg: ModelConfig
                      ) -> Tuple[torch.Tensor, List[Params]]:
    """Resident decode step: `stack_decode_step_layerwise` with the dense
    FFN on the resident weights (the reference's scan and its layerwise
    loop run the same math; in the port they are one loop)."""
    return stack_decode_step_layerwise(stack, x, position, cache, cfg)
