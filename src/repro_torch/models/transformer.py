"""Decoder stack: attention / SSM mixers + dense / MoE FFNs, run as a
Python loop.

The reference scans its stack with `lax.scan` over parameters stacked
[G, ...] along a group axis (G = n_layers / period P). The port keeps the
same grouping but holds it as a list: `stack[g]` is group g's dict
{"sub_j": sublayer params}, and caches mirror it (`cache[g]["sub_j"]` is a
`KVCache`, a `QuantKVCache` when `cfg.kv_quant`, a ring, a paged arena,
or for an SSM sublayer its recurrent state: `ssm.MambaState`,
`MLSTMState` or `SLSTMState`). Mixer kinds: attention, Mamba, mLSTM,
sLSTM; FFN kinds: dense, MoE (`models/moe.py`), none.

Decode attention over a paged arena goes through
`kernels.ops.paged_decode_attention`, over a sliding-window ring
(`swa=True` caches) through `kernels.ops.swa_decode_attention`, and the
predictor-driven `serve_sparse` decode FFN through
`kernels.ops.sparse_ffn_segments` (the hand-written kernels on the card).
The encoder-decoder stack is `models/encdec.py`; a VLM's backbone is
this stack.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.dtensor import batch_placed
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm
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
                                        quant_kv_write_rows, swa_attend,
                                        swa_write)
from repro_torch.models.layers import (_project_qkv, apply_norm,
                                       attention_forward, ffn_forward,
                                       init_attention, init_ffn,
                                       init_ffn_predictor, init_norm,
                                       maybe_checkpoint, promoted_matmul,
                                       rope,
                                       sparse_ffn_decode)
from repro_torch.obs import get_tracer

Params = Dict[str, Any]


def stack_period(cfg: ModelConfig) -> int:
    kinds, ffns, attns = cfg.layer_kinds(), cfg.ffn_kinds(), cfg.attn_kinds()
    L = cfg.n_layers
    for P in range(1, L + 1):
        if L % P:
            continue
        if all(kinds[i] == kinds[i % P] and ffns[i] == ffns[i % P]
               and attns[i] == attns[i % P] for i in range(L)):
            return P
    return L


def layer_attention(cfg: ModelConfig, attn_kind: str, window: int
                    ) -> Tuple[int, bool]:
    """(window, RoPE on) of an attention sublayer of `cfg.attn_kinds()`
    kind `attn_kind`, where the caller asks for `window` (0: none): a
    "window" layer keeps `cfg.sliding_window`, a "nope" layer takes no
    RoPE."""
    if attn_kind == "window":
        return cfg.sliding_window, True
    return window, attn_kind != "nope"


def routes_early(cfg: ModelConfig, ffn: str) -> bool:
    """Whether a sublayer's MoE router reads the attention's input (and
    runs before the attention) rather than the FFN's."""
    return ffn == "moe" and cfg.moe.router_input == "pre_attention"


# -- init ---------------------------------------------------------------------

class _SSMKind(NamedTuple):
    init: Callable
    forward: Callable
    decode_step: Callable
    init_state: Callable


_SSM = {k: _SSMKind(getattr(ssm, f"init_{k}"), getattr(ssm, f"{k}_forward"),
                    getattr(ssm, f"{k}_decode_step"),
                    getattr(ssm, f"{k}_init_state"))
        for k in ("mamba", "mlstm", "slstm")}


def _init_sublayer(gen: torch.Generator, cfg: ModelConfig, kind: str,
                   ffn: str) -> Params:
    p: Params = {"norm1": init_norm(cfg, gen.device)}
    if kind == "attn":
        p["mixer"] = init_attention(gen, cfg)
    elif kind in _SSM:
        p["mixer"] = _SSM[kind].init(gen, cfg)
    else:
        raise ValueError(kind)
    if ffn == "dense":
        p["norm2"] = init_norm(cfg, gen.device)
        p["ffn"] = init_ffn(gen, cfg)
        if cfg.serve_sparse:
            p["ffn_pred"] = init_ffn_predictor(gen, cfg)
    elif ffn == "moe":
        p["norm2"] = init_norm(cfg, gen.device)
        p["ffn"] = moe_lib.init_moe(gen, cfg)
    return p


def init_stack(gen: torch.Generator, cfg: ModelConfig) -> List[Params]:
    P = stack_period(cfg)
    G = cfg.n_layers // P
    kinds, ffns = cfg.layer_kinds(), cfg.ffn_kinds()
    return [{f"sub_{j}": _init_sublayer(gen, cfg, kinds[j], ffns[j])
             for j in range(P)} for _ in range(G)]


# -- full-sequence forward ------------------------------------------------------

class StackOutput(NamedTuple):
    x: torch.Tensor
    aux_loss: torch.Tensor                     # scalar (MoE load balance)
    ffn_pre_act: Optional[torch.Tensor]        # [L_dense, B, T, d_ff] if captured
    ffn_inputs: Optional[torch.Tensor] = None  # [L_dense, B, T, d_model] if captured


def _ffn_seq(sp: Params, h: torch.Tensor, cfg: ModelConfig, ffn: str,
             capture: bool = False, routing=None):
    """A sublayer's FFN over a sequence: (y, pre-activation if `capture`
    on a dense FFN, the normed input, MoE aux loss or None). `routing`:
    a MoE router's result taken before the attention."""
    normed2 = apply_norm(sp["norm2"], h, cfg)
    if ffn == "dense":
        y, pre = ffn_forward(sp["ffn"], normed2, cfg, capture=capture)
        return y, pre, normed2, None
    y, aux = moe_lib.moe_forward(sp["ffn"], normed2, cfg, routing)
    return y, None, normed2, aux


def _early_routing(sp: Params, normed: torch.Tensor, cfg: ModelConfig,
                   ffn: str):
    """The MoE routing of a sublayer whose router reads the attention's
    normed input [B, T, d] (None for any other sublayer)."""
    if not routes_early(cfg, ffn):
        return None
    return moe_lib.route(sp["ffn"], normed.reshape(-1, normed.shape[-1]),
                         cfg)


def stack_forward(stack: List[Params], x: torch.Tensor,
                  positions: torch.Tensor, cfg: ModelConfig, window: int = 0,
                  capture_activations: bool = False) -> StackOutput:
    """The stack over a whole sequence, one group at a time; a group is
    rematerialised in the backward pass when `cfg.remat` (the reference
    checkpoints its scanned group function)."""
    P = stack_period(cfg)
    kinds, ffns, attns = cfg.layer_kinds(), cfg.ffn_kinds(), cfg.attn_kinds()

    def group_fn(h, group):
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        caps: List[torch.Tensor] = []
        caps_h: List[torch.Tensor] = []
        for j in range(P):
            sp, kind, ffn = group[f"sub_{j}"], kinds[j], ffns[j]
            normed = apply_norm(sp["norm1"], h, cfg)
            routing = _early_routing(sp, normed, cfg, ffn)
            if kind == "attn":
                w, use_rope = layer_attention(cfg, attns[j], window)
                mix, _, _ = attention_forward(sp["mixer"], normed, positions,
                                              cfg, window=w,
                                              use_rope=use_rope)
            else:
                mix = _SSM[kind].forward(sp["mixer"], normed, cfg)
            h = h + mix
            if ffn != "none":
                y, pre, normed2, a = _ffn_seq(sp, h, cfg, ffn,
                                              capture=capture_activations,
                                              routing=routing)
                if a is not None:
                    aux = aux + a
                elif capture_activations:
                    caps.append(pre)
                    caps_h.append(normed2)
                h = h + y
        return h, aux, caps, caps_h

    captures: List[torch.Tensor] = []
    captures_h: List[torch.Tensor] = []
    aux_loss = torch.zeros((), dtype=torch.float32, device=x.device)
    h = x
    for group in stack:
        h_in = h
        h, aux, caps, caps_h = maybe_checkpoint(cfg, group_fn, h, group)
        h = batch_placed(h, like=h_in)
        aux_loss = aux_loss + aux
        captures += caps
        captures_h += caps_h
    pre_act = ffn_inputs = None
    if capture_activations and captures:
        pre_act = torch.stack(captures)
        ffn_inputs = torch.stack(captures_h)
    return StackOutput(x=h, aux_loss=aux_loss, ffn_pre_act=pre_act,
                       ffn_inputs=ffn_inputs)


# -- caches ----------------------------------------------------------------------

def init_stack_cache(cfg: ModelConfig, batch: int, max_len: int, device,
                     swa: bool = False, dtype=None) -> List[Params]:
    """Per group, {"sub_j": cache}: for an attention sublayer a KVCache
    [batch, max_len, KV, hd], the int8 `QuantKVCache` when `cfg.kv_quant`,
    or with `swa` a float `SWACache` ring of `cfg.sliding_window` slots a
    row (whatever `max_len` and `kv_quant` say, as in the reference), as
    a "window" sublayer of `cfg.attn_layout` always has; for an SSM
    sublayer its zero recurrent state (Mamba's conv inputs in `dtype`,
    default the compute dtype; every other leaf float32)."""
    P = stack_period(cfg)
    G = cfg.n_layers // P
    kinds, attns = cfg.layer_kinds(), cfg.attn_kinds()

    def one(kind, attn):
        if kind != "attn":
            return _SSM[kind].init_state(batch, cfg, device,
                                         dtype or cfg.dtype())
        if swa or attn == "window":
            return init_swa_cache(batch, cfg, device, dtype)
        if cfg.kv_quant:
            return init_quant_kv_cache(batch, max_len, cfg, device)
        return init_kv_cache(batch, max_len, cfg, device, dtype)

    return [{f"sub_{j}": one(kinds[j], attns[j]) for j in range(P)}
            for _ in range(G)]


def init_paged_stack_cache(cfg: ModelConfig, num_pages: int, page_size: int,
                           device, dtype=None) -> List[Params]:
    """Paged cache: per group, {"sub_j": a page arena [num_pages + 1,
    page_size, KV, hd]} (the trailing null page absorbs inactive-slot
    writes), int8 with scales when `cfg.kv_quant`. One set of `num_pages`
    logical pages serves every layer: a page-table entry indexes all
    arenas at once, so allocator accounting stays per request. A "window"
    sublayer of `cfg.attn_layout` has no arena (its group's dict leaves it
    out): it keeps a ring a slot (`init_ring_stack_cache`).

    Raises ValueError for stacks the paged layout cannot represent (SSM
    sublayers keep per-slot recurrent state, not positional KV; a stack
    windowed everywhere has nothing to page) — no silent fallback to a
    contiguous cache."""
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
    P = stack_period(cfg)
    G = cfg.n_layers // P
    attns = cfg.attn_kinds()
    if all(a == "window" for a in attns):
        raise ValueError(
            f"paged KV cache needs a layer that is not windowed; every "
            f"layer of {cfg.arch_id!r} keeps a sliding-window ring")

    def one():
        if cfg.kv_quant:
            return init_paged_quant_kv_cache(num_pages, page_size, cfg, device)
        return init_paged_kv_cache(num_pages, page_size, cfg, device, dtype)

    return [{f"sub_{j}": one() for j in range(P) if attns[j] != "window"}
            for _ in range(G)]


def init_ring_stack_cache(cfg: ModelConfig, batch: int, device,
                          dtype=None) -> List[Params]:
    """The rings a paged stack keeps beside its arenas: per group,
    {"sub_j": SWACache [batch, cfg.sliding_window]} for each "window"
    sublayer of `cfg.attn_layout` (empty dicts for a stack without
    any)."""
    P = stack_period(cfg)
    G = cfg.n_layers // P
    attns = cfg.attn_kinds()
    return [{f"sub_{j}": init_swa_cache(batch, cfg, device, dtype)
             for j in range(P) if attns[j] == "window"} for _ in range(G)]


# -- prefill ----------------------------------------------------------------------

def stack_prefill(stack: List[Params], x: torch.Tensor,
                  positions: torch.Tensor, cache: List[Params],
                  cfg: ModelConfig, window: int = 0
                  ) -> Tuple[torch.Tensor, List[Params]]:
    """Dense prefill over the prompt; fills `cache` in place from slot 0
    (an SSM sublayer's entry becomes its state after the prompt)."""
    P = stack_period(cfg)
    kinds, ffns, attns = cfg.layer_kinds(), cfg.ffn_kinds(), cfg.attn_kinds()
    h = x
    for group, group_cache, j in ((g, c, j) for g, c in zip(stack, cache)
                                  for j in range(P)):
        sp, kind, ffn = group[f"sub_{j}"], kinds[j], ffns[j]
        normed = apply_norm(sp["norm1"], h, cfg)
        routing = _early_routing(sp, normed, cfg, ffn)
        cj = group_cache[f"sub_{j}"]
        if kind == "attn":
            w, use_rope = layer_attention(cfg, attns[j], window)
            mix, k, v = attention_forward(sp["mixer"], normed, positions, cfg,
                                          window=w, use_rope=use_rope)
            if isinstance(cj, SWACache):
                swa_write(cj, k, v, positions)
            else:
                (quant_kv_write if isinstance(cj, QuantKVCache)
                 else kv_write)(cj, k, v, 0)
        else:
            mix, group_cache[f"sub_{j}"] = _SSM[kind].forward(
                sp["mixer"], normed, cfg, return_state=True)
        h = h + mix
        if ffn != "none":
            h = h + _ffn_seq(sp, h, cfg, ffn, routing=routing)[0]
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
    """The step's `PagedStep` when its caches hold paged arenas (None for
    contiguous caches and rings alone). Raises ValueError for a paged
    cache without page tables or per-slot positions."""
    first = next((c for g in cache_groups for c in g.values()
                  if isinstance(c, (PagedKVCache, PagedQuantKVCache))), None)
    if first is None:
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
                  kind: str = "attn", paged: Optional[PagedStep] = None,
                  window: int = 0, swa_cur: Optional[torch.Tensor] = None,
                  use_rope: bool = True, route_layer: Optional[int] = None
                  ) -> Tuple[torch.Tensor, Any, Any]:
    """One sublayer's mixer for a single decode token: (mix [B,1,d], cache,
    routing). With `route_layer` (the sublayer's MoE router reads the
    attention's input) routing is `moe.route` of the normed input, run
    before the attention in a `route` span; else None. No RoPE where
    `use_rope` is False (a NoPE layer).

    `position` is a shared scalar or a per-slot [B] vector; the contiguous
    cache writes pick the matching (slice vs per-row scatter) variant. A
    paged arena takes its write through `paged.targets` and attends through
    `ops.paged_decode_attention`; a sliding-window ring is written at
    pos % W and attended through `ops.swa_decode_attention` with the
    per-row positions `swa_cur` and `window or cfg.sliding_window` (both
    ops: the plain version on the CPU, the hand-written kernel on the
    card). An SSM sublayer (`kind` other than "attn") takes one step of
    its recurrence from its state `cj` instead."""
    normed = apply_norm(sp["norm1"], h, cfg)
    routing = None
    if route_layer is not None:
        with get_tracer().span("route", layer=route_layer):
            routing = moe_lib.route(sp["ffn"], normed[:, 0], cfg)
    if kind != "attn":
        y, cj = _SSM[kind].decode_step(sp["mixer"], normed[:, 0], cj, cfg)
        return y[:, None], cj, routing
    q, k, v = _project_qkv(sp["mixer"], normed, normed, cfg)
    if use_rope:
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
        cj = swa_write(cj, k, v, pos_arr)
        out = swa_attend(q[:, 0].contiguous(), cj, swa_cur,
                         window or cfg.sliding_window)
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
    return promoted_matmul(mix, sp["mixer"]["wo"]), cj, routing


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
    (`sparse_ffn_decode`), else the dense FFN; a MoE sublayer always runs
    `moe_forward` over the whole batch (its capacity counts every row), in
    a `moe` span (layer, rows), routed from the attention's input where
    the config says so (a `route` span inside `mixer`); while tracing, a
    dropless MoE keeps its count of distinct experts, on the device, in
    the tracer (`keep("moe_experts", ...)`, a layer each). SSM sublayers step their states. `window`
    is the sliding-window rings' attention window (0:
    `cfg.sliding_window`); a "window" sublayer of `cfg.attn_layout` keeps
    its own, a "nope" one takes no RoPE.
    `dense_layer_idx` counts dense FFN sublayers in (group, sublayer) order,
    the same order `stack_forward(capture_activations=True)` stacks
    `ffn_pre_act`, so calibration traces and serving agree on layer ids.
    `page_tables` routes paged arenas (from `init_paged_stack_cache`); the
    one page table serves every layer. Caches are updated in place. Each
    layer's mixer (its attention or SSM step and the residual add) is one
    `mixer` span of the tracer."""
    B = x.shape[0]
    pos_arr = _decode_positions(position, B, x.device)
    paged = _paged_step(position, page_tables, cache_groups)
    # one [B] int32 copy of the positions per step, for every ring
    swa_cur = (pos_arr[:, 0].to(torch.int32)
               if any(isinstance(c, SWACache) for g in cache_groups
                      for c in g.values())
               else None)
    h = x
    dense_idx = 0
    P = stack_period(cfg)
    kinds, ffns, attns = cfg.layer_kinds(), cfg.ffn_kinds(), cfg.attn_kinds()
    tr = get_tracer()
    for g, (group_params, group_cache) in enumerate(zip(param_groups,
                                                       cache_groups)):
        for j in range(P):
            sp = group_params[f"sub_{j}"]
            layer = g * P + j
            w, use_rope = layer_attention(cfg, attns[j], window)
            with tr.span("mixer", layer=layer):
                mix, group_cache[f"sub_{j}"], routing = _mixer_decode(
                    sp, group_cache[f"sub_{j}"], h, pos_arr, position, cfg,
                    kinds[j], paged, w, swa_cur, use_rope,
                    layer if routes_early(cfg, ffns[j]) else None)
                h = h + mix
            if ffns[j] == "moe":
                with tr.span("moe", layer=layer, rows=B):
                    normed2 = apply_norm(sp["norm2"], h, cfg)
                    if cfg.moe.dropless and tr.enabled:
                        if routing is None:
                            routing = moe_lib.route(sp["ffn"], normed2[:, 0],
                                                    cfg)
                        tr.keep("moe_experts", moe_lib.distinct_experts(
                            routing[2], cfg.moe.n_experts))
                    h = h + moe_lib.moe_forward(sp["ffn"], normed2, cfg,
                                                routing)[0]
            elif ffns[j] == "dense":
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
