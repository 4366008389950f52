"""Neuron co-activation statistics (paper §4.1, Eq. 1-2).

Records activation frequencies f(n_i) and co-activation frequencies f(n_i, n_j)
from FFN activation-mask traces, and exposes the probabilities P(i), P(ij) and the
distance dist(i, j) = 1 - P(ij) (Eq. 3) used by the placement search.

Neuron *bundles* (the paper's row-column bundling unit: the gate/up rows + down
column activated by the same intermediate value) are the unit of accounting — one
"neuron" here is one bundle.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Optional

import numpy as np


@dataclasses.dataclass
class CoActivationStats:
    """Accumulates the adjacency (co-activation count) matrix for one FFN block.

    Memory: the dense pair-count matrix is float32 [n, n]; for the largest model
    in the paper (n=43008) this is ~7.4 GB, so large-n users should accumulate
    per-layer (layers are independent, as the paper parallelises over layers).
    """

    n_neurons: int

    def __post_init__(self) -> None:
        self.counts = np.zeros(self.n_neurons, dtype=np.int64)
        self.pair_counts = np.zeros((self.n_neurons, self.n_neurons), dtype=np.float32)
        self.n_tokens = 0

    def update(self, masks: np.ndarray) -> None:
        """masks: [T, n] bool/0-1 activation mask for T tokens."""
        masks = np.asarray(masks)
        if masks.ndim == 1:
            masks = masks[None]
        if masks.shape[-1] != self.n_neurons:
            raise ValueError(f"mask width {masks.shape[-1]} != n_neurons {self.n_neurons}")
        m = masks.astype(np.float32)
        self.counts += masks.astype(np.int64).sum(axis=0)
        # A += M^T M — co-activation outer-product accumulation. This is the
        # offline hot spot; kept in numpy so decisions match the reference.
        self.pair_counts += m.T @ m
        self.n_tokens += masks.shape[0]

    # -- probabilities (Eq. 1, 2) -------------------------------------------
    def p_single(self) -> np.ndarray:
        total = self.counts.sum()
        if total == 0:
            return np.zeros(self.n_neurons)
        return self.counts / total

    def p_pair(self) -> np.ndarray:
        total = self.pair_counts.sum()
        if total == 0:
            return np.zeros_like(self.pair_counts)
        return self.pair_counts / total

    # -- distances (Eq. 3) ---------------------------------------------------
    def distance_matrix(self) -> np.ndarray:
        """dist(i, j) = 1 - P(ij); diagonal is +inf (no self edges)."""
        d = 1.0 - self.p_pair()
        np.fill_diagonal(d, np.inf)
        return d

    def activation_rate(self) -> np.ndarray:
        """Per-neuron empirical activation probability (per token)."""
        if self.n_tokens == 0:
            return np.zeros(self.n_neurons)
        return self.counts / self.n_tokens

    def merge(self, other: "CoActivationStats",
              inplace: bool = False) -> "CoActivationStats":
        """Combine two accumulators. `inplace=True` folds `other` into `self`
        (and returns self) without allocating a third [n, n] pair matrix —
        what the shard-streaming path uses to keep one running matrix."""
        if other.n_neurons != self.n_neurons:
            raise ValueError("cannot merge stats of different widths")
        if inplace:
            self.counts += other.counts
            self.pair_counts += other.pair_counts
            self.n_tokens += other.n_tokens
            return self
        out = CoActivationStats(self.n_neurons)
        out.counts = self.counts + other.counts
        out.pair_counts = self.pair_counts + other.pair_counts
        out.n_tokens = self.n_tokens + other.n_tokens
        return out


def stats_from_masks(masks: np.ndarray) -> CoActivationStats:
    s = CoActivationStats(masks.shape[-1])
    s.update(masks)
    return s


def stats_from_mask_shards(shards: Iterable[np.ndarray],
                           n_neurons: Optional[int] = None) -> CoActivationStats:
    """`stats_from_masks` over a shard iterator (traces larger than RAM).

    Each shard is accumulated into its own `CoActivationStats` and folded in
    via `CoActivationStats.merge(inplace=True)`, so only one shard's masks,
    its [n, n] pair matrix, and the single running pair matrix are resident
    at a time — the entry point the offline packer uses with
    `repro_torch.core.trace.iter_trace_shards`. An empty iterator needs
    `n_neurons` to size the (zero) stats.
    """
    out: Optional[CoActivationStats] = None
    for masks in shards:
        s = stats_from_masks(np.asarray(masks))
        out = s if out is None else out.merge(s, inplace=True)
    if out is None:
        if n_neurons is None:
            raise ValueError("empty shard iterator and no n_neurons given")
        out = CoActivationStats(n_neurons)
    return out


def expected_io_ops(masks: Iterable[np.ndarray], placement: np.ndarray) -> float:
    """Average number of contiguous read runs per token under a placement.

    This is the objective the Hamiltonian-path search minimises (Eq. 4-5): each
    maximal run of activated neurons that is contiguous in the *physical* layout
    costs one I/O op.
    """
    inv = np.empty_like(placement)
    inv[placement] = np.arange(len(placement))
    total_runs = 0
    n_tok = 0
    for mask_block in masks:
        mask_block = np.atleast_2d(np.asarray(mask_block))
        for mask in mask_block:
            ids = np.nonzero(mask)[0]
            if len(ids) == 0:
                continue
            phys = np.sort(inv[ids])
            runs = 1 + int(np.sum(np.diff(phys) > 1))
            total_runs += runs
            n_tok += 1
    return total_runs / max(n_tok, 1)
