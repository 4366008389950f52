"""Decoder stack: attention + dense FFN layers, run as a Python loop.

The reference scans its stack with `lax.scan` over parameters stacked
[G, ...] along a group axis (G = n_layers / period). The port keeps the
same grouping but holds it as a list: `stack[g]` is group g's dict
{"sub_j": sublayer params}, and caches mirror it (`cache[g]["sub_j"]` is a
`KVCache`, a `QuantKVCache` when `cfg.kv_quant`, or a paged arena). For the
dense decoder-only models the port serves, the period is 1, so group g is
layer g.

Decode attention over a paged arena goes through
`kernels.ops.paged_decode_attention`, over a sliding-window ring
(`swa=True` caches) through `kernels.ops.swa_decode_attention`, and the
predictor-driven `serve_sparse` decode FFN through
`kernels.ops.sparse_ffn_segments` (the hand-written kernels on the card).
Only attention mixers and dense FFNs are ported; SSM and MoE sublayers
raise ValueError.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.kvcache import (KVCache, PagedKVCache,
                                        PagedQuantKVCache, QuantKVCache,
                                        SWACache, attend_full_cache,
                                        init_kv_cache, init_paged_kv_cache,
                                        init_paged_quant_kv_cache,
                                        init_quant_kv_cache, init_swa_cache,
                                        kv_write, kv_write_rows,
                                        paged_kv_write_rows,
                                        paged_quant_kv_write_rows,
                                        paged_targets, quant_kv_write,
                                        quant_kv_write_rows, swa_write)
from repro_torch.models.layers import (_project_qkv, apply_norm,
                                       attention_forward, ffn_forward,
                                       init_attention, init_ffn,
                                       init_ffn_predictor, init_norm, rope,
                                       sparse_ffn_decode)

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


# -- init ---------------------------------------------------------------------

def _init_sublayer(gen: torch.Generator, cfg: ModelConfig, ffn: str) -> Params:
    p: Params = {"norm1": init_norm(cfg, gen.device),
                 "mixer": init_attention(gen, cfg)}
    if ffn == "dense":
        p["norm2"] = init_norm(cfg, gen.device)
        p["ffn"] = init_ffn(gen, cfg)
        if cfg.serve_sparse:
            p["ffn_pred"] = init_ffn_predictor(gen, cfg)
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
    """Per group, {"sub_j": KVCache [batch, max_len, KV, hd]}, the int8
    `QuantKVCache` when `cfg.kv_quant`, or with `swa` a float `SWACache`
    ring of `cfg.sliding_window` slots a row (whatever `max_len` and
    `kv_quant` say, as in the reference)."""
    check_supported(cfg)
    P = stack_period(cfg)
    G = cfg.n_layers // P

    def one():
        if swa:
            return init_swa_cache(batch, cfg, device, dtype)
        if cfg.kv_quant:
            return init_quant_kv_cache(batch, max_len, cfg, device)
        return init_kv_cache(batch, max_len, cfg, device, dtype)

    return [{f"sub_{j}": one() for j in range(P)} for _ in range(G)]


def init_paged_stack_cache(cfg: ModelConfig, num_pages: int, page_size: int,
                           device, dtype=None) -> List[Params]:
    """Paged cache: per group, {"sub_j": a page arena [num_pages + 1,
    page_size, KV, hd]} (the trailing null page absorbs inactive-slot
    writes), int8 with scales when `cfg.kv_quant`. One set of `num_pages`
    logical pages serves every layer: a page-table entry indexes all
    arenas at once, so allocator accounting stays per request.

    Raises ValueError for stacks the paged layout cannot represent (SSM
    sublayers keep per-slot recurrent state, not positional KV) — no silent
    fallback to a contiguous cache."""
    if num_pages < 1 or page_size < 1:
        raise ValueError(f"paged cache needs num_pages >= 1 and page_size >= 1, "
                         f"got num_pages={num_pages} page_size={page_size}")
    kinds = cfg.layer_kinds()
    if any(k != "attn" for k in kinds):
        raise ValueError(
            f"paged KV cache covers attention-only stacks; config "
            f"{cfg.arch_id!r} has layer kinds {sorted(set(kinds))} (SSM "
            f"sublayers carry per-slot recurrent state, which pages cannot "
            f"represent)")
    check_supported(cfg)
    P = stack_period(cfg)
    G = cfg.n_layers // P

    def one():
        if cfg.kv_quant:
            return init_paged_quant_kv_cache(num_pages, page_size, cfg, device)
        return init_paged_kv_cache(num_pages, page_size, cfg, device, dtype)

    return [{f"sub_{j}": one() for j in range(P)} for _ in range(G)]


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
        cj = group_cache[f"sub_{j}"]
        if isinstance(cj, SWACache):
            swa_write(cj, k, v, positions)
        else:
            (quant_kv_write if isinstance(cj, QuantKVCache) else kv_write)(
                cj, k, v, 0)
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


class PagedStep(NamedTuple):
    """What every paged attention sublayer of one decode step shares,
    computed once per step: the page tables, the per-row query positions,
    and each row's (page, offset) write target."""
    page_tables: torch.Tensor   # [B, max_pages] int32
    cur_pos: torch.Tensor       # [B] int32
    targets: Tuple[torch.Tensor, torch.Tensor]


def _paged_step(position, page_tables: Optional[torch.Tensor],
                cache_groups: List[Params]) -> Optional[PagedStep]:
    """The step's `PagedStep` when its caches are paged arenas (None for
    contiguous caches). Raises ValueError for a paged cache without page
    tables or per-slot positions."""
    first = next(iter(cache_groups[0].values())) if cache_groups else None
    if not isinstance(first, (PagedKVCache, PagedQuantKVCache)):
        return None
    if page_tables is None:
        raise ValueError("paged KV cache decode needs page_tables")
    if torch.as_tensor(position).ndim != 1:
        raise ValueError("paged KV cache decode needs per-slot [B] "
                         "positions (continuous batching)")
    cur_pos = torch.as_tensor(position, device=page_tables.device).to(
        torch.int32)
    return PagedStep(page_tables=page_tables, cur_pos=cur_pos,
                     targets=paged_targets(cur_pos, page_tables,
                                           first.page_size))


def _mixer_decode(sp: Params, cj: Any, h: torch.Tensor,
                  pos_arr: torch.Tensor, position, cfg: ModelConfig,
                  paged: Optional[PagedStep] = None, window: int = 0,
                  swa_cur: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, Any]:
    """One attention sublayer for a single decode token: (mix [B,1,d], cache).

    `position` is a shared scalar or a per-slot [B] vector; the contiguous
    cache writes pick the matching (slice vs per-row scatter) variant. A
    paged arena takes its write through `paged.targets` and attends through
    `ops.paged_decode_attention`; a sliding-window ring is written at
    pos % W and attended through `ops.swa_decode_attention` with the
    per-row positions `swa_cur` and `window or cfg.sliding_window` (both
    ops: the plain version on the CPU, the hand-written kernel on the
    card)."""
    normed = apply_norm(sp["norm1"], h, cfg)
    q, k, v = _project_qkv(sp["mixer"], normed, normed, cfg)
    q = rope(q, pos_arr, cfg.rope_theta)
    k = rope(k, pos_arr, cfg.rope_theta)
    per_row = torch.as_tensor(position).ndim == 1
    if isinstance(cj, (PagedKVCache, PagedQuantKVCache)):
        # imported here: the kernels' plain versions import this package
        from repro_torch.kernels import ops
        q1 = q[:, 0].float().contiguous()
        if isinstance(cj, PagedQuantKVCache):
            cj = paged_quant_kv_write_rows(cj, k, v, paged.targets)
            out = ops.paged_decode_attention(
                q1, cj.k, cj.v, paged.page_tables, paged.cur_pos,
                k_scale=cj.k_scale, v_scale=cj.v_scale)
        else:
            cj = paged_kv_write_rows(cj, k, v, paged.targets)
            out = ops.paged_decode_attention(
                q1, cj.k, cj.v, paged.page_tables, paged.cur_pos)
        # [B, H, hd] f32 back to the [B, 1, H*hd] residual layout
        B, H, hd = out.shape
        mix = out.reshape(B, 1, H * hd).to(q.dtype)
    elif isinstance(cj, SWACache):
        from repro_torch.kernels import ops
        cj = swa_write(cj, k, v, pos_arr)
        out = ops.swa_decode_attention(q[:, 0].contiguous(), cj.k, cj.v,
                                       cj.pos, swa_cur,
                                       window=window or cfg.sliding_window)
        B, H, hd = out.shape
        mix = out.reshape(B, 1, H * hd)
    elif isinstance(cj, QuantKVCache):
        cj = (quant_kv_write_rows(cj, k, v, pos_arr[:, 0]) if per_row
              else quant_kv_write(cj, k, v, position))
        mix = attend_full_cache(q, cj, pos_arr)
    elif isinstance(cj, KVCache):
        cj = (kv_write_rows(cj, k, v, pos_arr[:, 0]) if per_row
              else kv_write(cj, k, v, position))
        mix = attend_full_cache(q, cj, pos_arr)
    else:
        raise ValueError(f"unsupported cache type {type(cj).__name__}")
    return mix @ sp["mixer"]["wo"], cj


FFNOverride = Callable[[int, torch.Tensor], torch.Tensor]


def stack_decode_step_layerwise(
    param_groups: List[Params],
    x: torch.Tensor,            # [B, 1, d]
    position,                   # scalar (shared) or [B] per-slot positions
    cache_groups: List[Params],
    cfg: ModelConfig,
    ffn_override: Optional[FFNOverride] = None,
    page_tables: Optional[torch.Tensor] = None,   # [B, max_pages] int32
    window: int = 0,
) -> Tuple[torch.Tensor, List[Params]]:
    """One decode step over every layer, on the host loop.

    `ffn_override(dense_layer_idx, normed2 [B,1,d]) -> y [B,1,d]` intercepts
    every dense-FFN sublayer — the offload serving path computes those from
    flash bundle payloads instead of the resident weights. Without it a
    `cfg.serve_sparse` model takes the predictor's segment top-k FFN
    (`sparse_ffn_decode`), else the dense FFN. `window` is the
    sliding-window rings' attention window (0: `cfg.sliding_window`).
    `dense_layer_idx` counts dense FFN sublayers in (group, sublayer) order,
    the same order `stack_forward(capture_activations=True)` stacks
    `ffn_pre_act`, so calibration traces and serving agree on layer ids.
    `page_tables` routes paged arenas (from `init_paged_stack_cache`); the
    one page table serves every layer. Caches are updated in place."""
    B = x.shape[0]
    pos_arr = _decode_positions(position, B, x.device)
    paged = _paged_step(position, page_tables, cache_groups)
    first = next(iter(cache_groups[0].values())) if cache_groups else None
    # one [B] int32 copy of the positions per step, for every ring
    swa_cur = (pos_arr[:, 0].to(torch.int32)
               if isinstance(first, SWACache) else None)
    h = x
    dense_idx = 0
    P = stack_period(cfg)
    ffns = cfg.ffn_kinds()
    for group_params, group_cache in zip(param_groups, cache_groups):
        for j in range(P):
            sp = group_params[f"sub_{j}"]
            mix, group_cache[f"sub_{j}"] = _mixer_decode(
                sp, group_cache[f"sub_{j}"], h, pos_arr, position, cfg,
                paged, window, swa_cur)
            h = h + mix
            if ffns[j] == "dense":
                normed2 = apply_norm(sp["norm2"], h, cfg)
                if ffn_override is not None:
                    y2 = ffn_override(dense_idx, normed2)
                elif cfg.serve_sparse:
                    y2 = sparse_ffn_decode(sp["ffn"], sp["ffn_pred"],
                                           normed2, cfg)
                else:
                    y2, _ = ffn_forward(sp["ffn"], normed2, cfg)
                dense_idx += 1
                h = h + y2
    return h, cache_groups


def stack_decode_step(stack: List[Params], x: torch.Tensor, position,
                      cache: List[Params], cfg: ModelConfig,
                      page_tables: Optional[torch.Tensor] = None,
                      window: int = 0
                      ) -> Tuple[torch.Tensor, List[Params]]:
    """Resident decode step: `stack_decode_step_layerwise` with the FFN on
    the resident weights (the reference's scan and its layerwise loop run
    the same math; in the port they are one loop)."""
    return stack_decode_step_layerwise(stack, x, position, cache, cfg,
                                       page_tables=page_tables, window=window)
