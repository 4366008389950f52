"""Mixture-of-Experts FFN: top-k router + capacity-based sort-free dispatch.

The reference's GShard-style formulation: tokens take per-expert capacity
slots by one-hot cumsum ranking, the experts run as batched products over
the expert axis (`torch.bmm` of [E, C, d] by [E, d, f]), and the outputs
are combined with the router weights. FLOPs scale with top_k x capacity
factor, not with n_experts. Load-balance auxiliary loss as in Switch /
GShard: E * sum_e(mean_router_prob_e * frac_tokens_e).

Three choices keep the result a function of the inputs on every device:

- top-k takes the lower expert index on ties (as `jax.lax.top_k`), through
  a stable descending sort; `torch.topk` promises no order on the card.
- Capacity overflow. The reference scatters an overflowing (token, expert)
  pair to slot C-1 of its expert with the sentinel token T and gate 0
  (`src/repro/models/moe.py:71-73,84-86`); the last write wins, so once an
  expert overflows, the token that held its slot C-1 loses that expert
  too. The port computes that rule outright (slot C-1 of an overflowing
  expert is empty) and scatters each kept (token, expert) pair to a slot
  of its own, because a scatter of duplicate indices has no defined order
  on CUDA.
- The combine gathers each token's K expert outputs and sums them in k
  order, in place of the reference's scatter-add, so repeated runs give
  the same bits (no atomics).

`MoEConfig.dropless` takes the other dispatch, `moe_forward_dropless`:
every routed (token, expert) pair is computed once and none is dropped,
so a row's output does not depend on its batch mates. The pairs are
sorted by expert (stable, so each expert's rows keep token order) and run
as grouped products, whose work scales with the pairs and not with
n_experts x tokens: `torch._grouped_mm` on bf16 on the card (the group
ends stay on the device: nothing waits on the host), a loop over the
experts elsewhere (`grouped_mm_loop`, its twin). A router may run before
the attention (`MoEConfig.router_input`): the stack then hands its
routing to `moe_forward`.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.distributed.dtensor import pin, whole
from repro_torch.models.layers import _normal, apply_activation

Params = Dict[str, torch.Tensor]
Routing = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def init_moe(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """Router [d, E] and stacked expert weights w_gate / w_up [E, d, f],
    w_down [E, f, d], with the reference init's shapes and scales."""
    assert cfg.moe is not None
    m = cfg.moe
    d, f, E, dt = cfg.d_model, m.d_ff_expert, m.n_experts, cfg.pdtype()
    return {"router": _normal(gen, (d, E), dt, d ** -0.5),
            "w_gate": _normal(gen, (E, d, f), dt, d ** -0.5),
            "w_up": _normal(gen, (E, d, f), dt, d ** -0.5),
            "w_down": _normal(gen, (E, f, d), dt, f ** -0.5)}


def _capacity(n_tokens: int, m: MoEConfig) -> int:
    c = int(n_tokens * m.top_k * m.capacity_factor / m.n_experts) + 1
    return max(4, -(-c // 4) * 4)   # round up to a multiple of 4


def route(p: Params, xt: torch.Tensor, cfg: ModelConfig
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """xt: [T, d] -> (router probs [T, E] f32, normalised gate weights
    [T, K] f32, selected experts [T, K] int64). Ties go to the lower
    expert index."""
    K = cfg.moe.top_k
    logits = (xt @ p["router"].to(cfg.dtype())).float()
    probs = torch.softmax(logits, dim=-1)
    gate_w, sel = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_w, sel = gate_w[:, :K], sel[:, :K]
    gate_w = gate_w / torch.clamp_min(gate_w.sum(-1, keepdim=True), 1e-9)
    return probs, gate_w, sel


def _aux_loss(probs: torch.Tensor, sel: torch.Tensor, m: MoEConfig
              ) -> torch.Tensor:
    """E * sum_e(mean router prob_e * fraction of routed slots_e)."""
    E, K = m.n_experts, m.top_k
    # counts by one-hot comparison, not `scatter_add_`, which has no
    # DTensor strategy (the same small integers)
    iota = torch.arange(E, device=sel.device)
    routed = (sel[:, :, None] == iota).sum(dim=1).to(probs.dtype)  # [T, E]
    frac_routed = routed.mean(dim=0) / K
    return E * torch.sum(probs.mean(dim=0) * frac_routed)


def _expert_ffn(p: Params, xe: torch.Tensor, cfg: ModelConfig
                ) -> torch.Tensor:
    """xe: [E, C, d] -> [E, C, d], each expert's gated silu FFN."""
    dt = cfg.dtype()
    h = apply_activation(torch.bmm(xe, p["w_gate"].to(dt)),
                         cfg.moe.activation)
    h = h * torch.bmm(xe, p["w_up"].to(dt))
    return torch.bmm(h, p["w_down"].to(dt))


def moe_forward(p: Params, x: torch.Tensor, cfg: ModelConfig,
                routing: Optional[Routing] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, d] -> (y [B, S, d], aux_loss scalar f32). `routing` is
    `route`'s result where the router has already run (on the attention's
    input); else the router reads x. A dropless config takes
    `moe_forward_dropless`."""
    assert cfg.moe is not None
    m = cfg.moe
    if m.dropless:
        return moe_forward_dropless(p, x, cfg, routing)
    B, S, d = x.shape
    T = B * S
    E, K = m.n_experts, m.top_k
    C = _capacity(T, m)
    # under sharding the tokens' gradient comes back as the rows had them
    # (the routing's backward may shard it over the model axis too, which
    # the view back to [B, S, d] cannot take)
    xt = pin(x.reshape(T, d))
    probs, gate_w, sel = route(p, xt, cfg) if routing is None else routing
    aux = _aux_loss(probs, sel, m)
    # the dispatch's bookkeeping below (ranks, slots, an in-place scatter
    # into a fresh tensor) has no DTensor strategy: under sharding it runs
    # on the whole routing decision, the same on every rank
    sel = whole(sel)

    # capacity ranking: position of each (token, k) in its expert's queue,
    # in token-major, k-minor order
    flat_sel = sel.reshape(-1)                                     # [T*K]
    onehot = (flat_sel[:, None] == torch.arange(E, device=x.device)).long()
    slot = (torch.cumsum(onehot, dim=0) - 1).gather(
        1, flat_sel[:, None])[:, 0]                                # [T*K]
    # an expert that overflows loses slot C-1 as well (the reference's
    # last write there is an overflowing pair's sentinel)
    overflow = onehot.sum(dim=0) > C                               # [E]
    keep = (slot < C) & ~((slot == C - 1) & overflow[flat_sel])

    # dispatch: (expert, slot) -> token. Kept pairs have unique slots;
    # dropped ones all go to a spare entry past the end, which is cut off,
    # so no kept slot is written twice (and nothing waits on the host)
    token_idx = torch.arange(T, device=x.device).repeat_interleave(K)
    dest = flat_sel * C + torch.clamp_max(slot, C - 1)             # [T*K]
    slot_token = torch.full((E * C + 1,), T, dtype=torch.int64,
                            device=x.device)
    slot_token.scatter_(0, torch.where(keep, dest, E * C), token_idx)
    slot_token = slot_token[:E * C]
    # the sentinel row made whole (a DTensor's `new_zeros` would shard
    # its one row like the tokens)
    sentinel = torch.zeros((1, d), dtype=xt.dtype, device=xt.device)
    xt_pad = torch.cat([xt, sentinel], dim=0)
    ye = _expert_ffn(p, xt_pad[slot_token].reshape(E, C, d), cfg)  # [E, C, d]

    # combine: each token's K outputs gathered and summed in k order
    w = torch.where(keep, gate_w.reshape(-1), 0.0).to(ye.dtype)    # [T*K]
    contrib = ye.reshape(E * C, d)[dest] * w[:, None]
    y = contrib.reshape(T, K, d).sum(dim=1)
    return y.reshape(B, S, d), aux.float()


def expert_order(sel: torch.Tensor, n_experts: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """sel [T, K] -> (order [T*K]: the (token, k) pairs sorted by expert,
    token-major within an expert; ends [E] int32: where each expert's
    pairs end in that order). No host read."""
    sorted_e, order = torch.sort(sel.reshape(-1), stable=True)
    iota = torch.arange(n_experts, device=sel.device, dtype=sorted_e.dtype)
    ends = torch.searchsorted(sorted_e, iota, right=True).to(torch.int32)
    return order, ends


def grouped_mm_loop(x: torch.Tensor, w: torch.Tensor, ends: torch.Tensor
                    ) -> torch.Tensor:
    """x [N, a] (rows grouped by expert, `ends` [E] where each group ends),
    w [E, a, b] -> [N, b]: each group's rows by its expert's matrix, one
    product an expert that has rows (reads `ends` on the host)."""
    out = x.new_empty((x.shape[0], w.shape[-1]))
    start = 0
    for e, end in enumerate(ends.tolist()):
        if end > start:
            out[start:end] = x[start:end] @ w[e]
        start = end
    return out


def grouped_mm(x: torch.Tensor, w: torch.Tensor, ends: torch.Tensor
               ) -> torch.Tensor:
    """`grouped_mm_loop`'s product: `torch._grouped_mm` for bf16 on the
    card (CUTLASS's grouped GEMM; the ends stay on the device), the loop
    elsewhere."""
    if x.is_cuda and x.dtype == w.dtype == torch.bfloat16:
        return torch._grouped_mm(x, w, offs=ends)
    return grouped_mm_loop(x, w, ends)


def moe_forward_dropless(p: Params, x: torch.Tensor, cfg: ModelConfig,
                         routing: Optional[Routing] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, d] -> (y [B, S, d], aux_loss scalar f32: 0 where no
    gradient is recorded), every routed pair computed: the pairs sorted by
    expert, each expert's gated FFN on its own rows (grouped products), the
    outputs put back in pair order and each token's K outputs summed in k
    order with its gate weights."""
    m = cfg.moe
    B, S, d = x.shape
    T, K = B * S, m.top_k
    xt = x.reshape(T, d)
    probs, gate_w, sel = route(p, xt, cfg) if routing is None else routing
    # the auxiliary loss trains the router alone: where no gradient is
    # recorded (serving) it is not computed
    aux = (_aux_loss(probs, sel, m) if torch.is_grad_enabled()
           else probs.new_zeros(()))
    order, ends = expert_order(sel, m.n_experts)
    dt = cfg.dtype()
    xs = xt[order // K]                                            # [T*K, d]
    h = apply_activation(grouped_mm(xs, p["w_gate"].to(dt), ends),
                         m.activation)
    h = h * grouped_mm(xs, p["w_up"].to(dt), ends)
    ys = grouped_mm(h, p["w_down"].to(dt), ends)
    y_pairs = torch.empty_like(ys).index_copy_(0, order, ys)
    w = gate_w.reshape(-1).to(ys.dtype)
    y = (y_pairs * w[:, None]).reshape(T, K, d).sum(dim=1)
    return y.reshape(B, S, d), aux.float()


def distinct_experts(sel: torch.Tensor, n_experts: int) -> torch.Tensor:
    """How many distinct experts `sel` [T, K] routes to, a device scalar
    (no host read)."""
    hit = torch.zeros(n_experts, dtype=torch.int32, device=sel.device)
    return hit.index_fill_(0, sel.reshape(-1), 1).sum()


def moe_forward_dense_einsum(p: Params, x: torch.Tensor, cfg: ModelConfig
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Test oracle: every expert on every token, weighted by the router's
    gates (O(E) FLOPs). Equal to `moe_forward` when no expert overflows."""
    assert cfg.moe is not None
    m = cfg.moe
    B, S, d = x.shape
    xt = x.reshape(-1, d)
    probs, gate_w, sel = route(p, xt, cfg)
    dense_gates = torch.zeros_like(probs).scatter_(1, sel, gate_w)  # [T, E]
    ye = _expert_ffn(p, xt[None].expand(m.n_experts, -1, -1), cfg)  # [E, T, d]
    y = torch.einsum("etd,te->td", ye, dense_gates.to(ye.dtype))
    return y.reshape(B, S, d), _aux_loss(probs, sel, m).float()
