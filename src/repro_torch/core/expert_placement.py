"""Expert-level co-activation linking for MoE architectures.

For MoE layers the RIPPLE unit is the EXPERT: top-k routing co-activates k
experts per token, and experts routed together should be contiguous in flash
so one continuous read covers a token's expert set. This is the same
Hamiltonian-path machinery as neuron placement, applied to the E x E expert
co-routing graph, plus within-expert neuron linking using the tokens routed
to that expert.

Offline inputs come from router traces: [T, top_k] expert-id selections.
The numpy logic is a copy of the reference package's
`core/expert_placement.py`; the co-routing and within-expert counts go
through the port's `CoActivationStats` on `device` (default cuda: the coact
kernel), whose counts are exact, so the placements are the reference's.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from repro_torch.core.coactivation import CoActivationStats
from repro_torch.core.placement import PlacementResult, search_placement
from repro_torch.device import DeviceLike


def routing_masks(sel: np.ndarray, n_experts: int) -> np.ndarray:
    """sel: [T, top_k] routed expert ids -> [T, E] 0/1 co-routing masks."""
    sel = np.asarray(sel)
    T = sel.shape[0]
    masks = np.zeros((T, n_experts), dtype=bool)
    masks[np.arange(T)[:, None], sel] = True
    return masks


def expert_coactivation(sel: np.ndarray, n_experts: int,
                        device: DeviceLike = None) -> CoActivationStats:
    stats = CoActivationStats(n_experts, device=device)
    stats.update(routing_masks(sel, n_experts))
    return stats


def search_expert_placement(sel: np.ndarray, n_experts: int,
                            device: DeviceLike = None) -> PlacementResult:
    """Expert flash order minimising expected reads per token (Eq. 4-5 at
    expert granularity). E is small — exact mode always."""
    stats = expert_coactivation(sel, n_experts, device=device)
    return search_placement(stats.distance_matrix(), mode="exact")


def expected_reads_per_token(sel: np.ndarray, n_experts: int,
                             placement: PlacementResult) -> float:
    """Mean number of contiguous extents covering each token's expert set."""
    sel = np.asarray(sel)
    inv = placement.inverse
    total = 0
    for row in sel:
        phys = np.sort(inv[np.unique(row)])
        total += 1 + int(np.sum(np.diff(phys) > 1))
    return total / max(len(sel), 1)


def within_expert_masks(
    token_masks: np.ndarray,       # [T, d_ff_expert] neuron activations
    sel: np.ndarray,               # [T, top_k] which experts each token used
    expert: int,
) -> np.ndarray:
    """Neuron activation masks restricted to tokens routed to `expert`."""
    routed = np.any(np.asarray(sel) == expert, axis=1)
    return np.asarray(token_masks)[routed]


def hierarchical_moe_placement(
    sel: np.ndarray,
    neuron_masks_per_expert: Optional[List[np.ndarray]],
    n_experts: int,
    device: DeviceLike = None,
) -> Tuple[PlacementResult, List[Optional[PlacementResult]]]:
    """Two-level RIPPLE for MoE: expert order in flash + per-expert neuron
    order. Returns (expert placement, per-expert neuron placements)."""
    expert_pl = search_expert_placement(sel, n_experts, device=device)
    neuron_pls: List[Optional[PlacementResult]] = []
    for e in range(n_experts):
        if neuron_masks_per_expert is None or neuron_masks_per_expert[e] is None \
                or len(neuron_masks_per_expert[e]) == 0:
            neuron_pls.append(None)
            continue
        stats = CoActivationStats(neuron_masks_per_expert[e].shape[1],
                                  device=device)
        stats.update(neuron_masks_per_expert[e])
        neuron_pls.append(search_placement(stats.distance_matrix(), mode="auto"))
    return expert_pl, neuron_pls


def synthetic_routing(n_tokens: int, n_experts: int, top_k: int,
                      n_groups: int = 4, seed: int = 0,
                      group_p: float = 0.85) -> np.ndarray:
    """Synthetic co-routed selections: experts belong to affinity groups;
    a token draws most of its top-k from one group (mirrors the observation
    that domain/topic tokens co-route)."""
    rng = np.random.default_rng(seed)
    groups = [np.array([e for e in range(n_experts) if e % n_groups == g])
              for g in range(n_groups)]
    sel = np.zeros((n_tokens, top_k), dtype=np.int64)
    for t in range(n_tokens):
        g = rng.integers(n_groups)
        pool = groups[g]
        for k in range(top_k):
            if rng.random() < group_p and len(pool) > 0:
                sel[t, k] = rng.choice(pool)
            else:
                sel[t, k] = rng.integers(n_experts)
        # top-k entries must be distinct experts
        row = np.unique(sel[t])
        while len(row) < top_k:
            row = np.unique(np.concatenate([row, [rng.integers(n_experts)]]))
        sel[t] = row[:top_k]
    return sel
