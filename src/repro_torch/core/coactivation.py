"""Neuron co-activation statistics (paper §4.1, Eq. 1-2).

Records activation frequencies f(n_i) and co-activation frequencies f(n_i, n_j)
from FFN activation-mask traces, and exposes the probabilities P(i), P(ij) and the
distance dist(i, j) = 1 - P(ij) (Eq. 3) used by the placement search.

Neuron *bundles* (the paper's row-column bundling unit: the gate/up rows + down
column activated by the same intermediate value) are the unit of accounting — one
"neuron" here is one bundle.
"""
from __future__ import annotations

from typing import Iterable, Optional, Union

import numpy as np
import torch

from repro_torch.device import DeviceLike, check_same_device, resolve_device
from repro_torch.kernels import ops

MaskLike = Union[np.ndarray, torch.Tensor]


class CoActivationStats:
    """Accumulates the adjacency (co-activation count) matrix for one FFN
    block on `device` (default cuda; the CPU only when asked for).

    `pair_counts` is a float32 [n, n] tensor on the device and `counts` an
    int64 [n] tensor; each `update` adds the block's MᵀM into `pair_counts`
    in place through `ops.coact_accumulate(..., accumulate_into=)` (on the
    card the kernel adds each tile into it, on the CPU the plain version
    `add_`s the product), the float adds of the reference's `+=`. The
    counts are exact integers, so the float32 bits equal the reference's
    numpy accumulation while each entry stays below 2^24 co-activations
    (the reference's float32 buffer has the same limit). Masks given on
    the host are copied to the device once for the count.

    The probabilities and distances (`p_single`, `p_pair`,
    `distance_matrix`, `activation_rate`) come back to the host as numpy,
    computed with the reference's numpy expressions, because the placement
    search runs in numpy: the [n, n] matrix crosses to the host once per
    call. Memory: the pair matrix is 4·n² bytes (n = 43008, the largest
    model in the paper, is about 7.4 GB), so accumulate per layer.
    """

    def __init__(self, n_neurons: int, device: DeviceLike = None) -> None:
        self.n_neurons = n_neurons
        self.device = resolve_device(device)
        self.counts = torch.zeros(n_neurons, dtype=torch.int64,
                                  device=self.device)
        self.pair_counts = torch.zeros((n_neurons, n_neurons),
                                       dtype=torch.float32, device=self.device)
        self.n_tokens = 0

    def _as_masks(self, masks: MaskLike) -> torch.Tensor:
        if isinstance(masks, torch.Tensor):
            check_same_device(self.device, masks.device, "the mask block")
            m = masks
        else:
            m = torch.from_numpy(np.ascontiguousarray(masks)).to(self.device)
        if m.ndim == 1:
            m = m[None]
        if m.shape[-1] != self.n_neurons:
            raise ValueError(f"mask width {m.shape[-1]} != n_neurons "
                             f"{self.n_neurons}")
        if self.device.type == "cuda" and m.dtype not in (torch.bool,
                                                          torch.uint8):
            m = self._as_bytes(m)
        return m

    @staticmethod
    def _as_bytes(m: torch.Tensor) -> torch.Tensor:
        """A mask of another dtype on the card, counted as the reference
        counts it (by value) through the kernel's byte route: its minimum,
        maximum and whether every value is an integer come to the host in
        one read, and `card_mask_route` decides."""
        if m.numel() == 0:
            return m.to(torch.uint8)
        integral = (torch.ones((), dtype=torch.bool, device=m.device)
                    if not m.dtype.is_floating_point
                    else (m == m.trunc()).all())
        vmin, vmax, whole = torch.stack(
            [m.amin().double(), m.amax().double(), integral.double()]).tolist()
        card_mask_route(m.dtype, vmin, vmax, bool(whole))
        return m.to(torch.uint8)

    def update(self, masks: MaskLike) -> None:
        """masks: [T, n] bool/0-1 activation mask for T tokens (numpy, or a
        tensor on this stats' device). Other values count by value, as in
        the reference; on the card only integers 0..255 do, and any other
        value raises (`card_mask_route`)."""
        m = self._as_masks(masks)
        self.counts += m.to(torch.int64).sum(dim=0)
        # A += MᵀM — the offline hot spot; on CUDA the coact kernel adds its
        # tiles into the pair matrix (no [n, n] temporary)
        ops.coact_accumulate(m, accumulate_into=self.pair_counts)
        self.n_tokens += m.shape[0]

    # -- host views -----------------------------------------------------------
    def counts_numpy(self) -> np.ndarray:
        return self.counts.cpu().numpy()

    def pair_counts_numpy(self) -> np.ndarray:
        return self.pair_counts.cpu().numpy()

    # -- probabilities (Eq. 1, 2) -------------------------------------------
    def p_single(self) -> np.ndarray:
        counts = self.counts_numpy()
        total = counts.sum()
        if total == 0:
            return np.zeros(self.n_neurons)
        return counts / total

    def p_pair(self) -> np.ndarray:
        pair = self.pair_counts_numpy()
        total = pair.sum()
        if total == 0:
            return np.zeros_like(pair)
        return pair / total

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
        return self.counts_numpy() / self.n_tokens

    def merge(self, other: "CoActivationStats",
              inplace: bool = False) -> "CoActivationStats":
        """Combine two accumulators on the same device. `inplace=True` folds
        `other` into `self` (and returns self) without allocating a third
        [n, n] pair matrix."""
        if other.n_neurons != self.n_neurons:
            raise ValueError("cannot merge stats of different widths")
        check_same_device(self.device, other.device, "the other stats")
        if inplace:
            self.counts += other.counts
            self.pair_counts += other.pair_counts
            self.n_tokens += other.n_tokens
            return self
        out = CoActivationStats(self.n_neurons, device=self.device)
        out.counts = self.counts + other.counts
        out.pair_counts = self.pair_counts + other.pair_counts
        out.n_tokens = self.n_tokens + other.n_tokens
        return out


def card_mask_route(dtype: torch.dtype, vmin=None, vmax=None,
                    integral: bool = True) -> str:
    """How the card counts a mask of `dtype` whose values lie in [vmin,
    vmax] (`integral`: every value is an integer). bool and uint8 masks go
    to the coact kernel as they are ("as_is": no value is read). Any other
    dtype whose values are all integers in 0..255 is copied to uint8
    ("uint8"), whose byte values the kernel counts exactly, as the
    reference counts values (`masks.astype(np.int64).sum`, a float32 MᵀM).
    Anything else raises ValueError: the card cannot count negative
    values, values above 255 or fractions exactly, and it binarises
    nothing."""
    if dtype in (torch.bool, torch.uint8):
        return "as_is"
    bad = []
    if not integral:
        bad.append("values that are not integers")
    if vmin is not None and vmin < 0:
        bad.append(f"a minimum of {vmin}")
    if vmax is not None and vmax > 255:
        bad.append(f"a maximum of {vmax}")
    if bad:
        raise ValueError(
            f"CoActivationStats on the card counts masks of integer values "
            f"0..255; this {dtype} mask has {' and '.join(bad)}, which the "
            f"coact kernel cannot count exactly (pass a bool or 0/1 mask, "
            f"or count it on the CPU)")
    return "uint8"


def stats_from_masks(masks: MaskLike,
                     device: DeviceLike = None) -> CoActivationStats:
    s = CoActivationStats(masks.shape[-1], device=device)
    s.update(masks)
    return s


def stats_from_mask_shards(shards: Iterable[MaskLike],
                           n_neurons: Optional[int] = None,
                           device: DeviceLike = None) -> CoActivationStats:
    """`stats_from_masks` over a shard iterator (traces larger than RAM).

    Each shard's MᵀM is added into one running pair matrix on `device`, so
    only one shard's masks, its [n, n] product and the running matrix are
    resident at a time — the entry point the offline packer uses with
    `repro_torch.core.trace.iter_trace_shards`. The sums are those of the
    reference's per-shard merge, bit for bit (exact integers). An empty
    iterator needs `n_neurons` to size the (zero) stats.
    """
    out: Optional[CoActivationStats] = None
    for masks in shards:
        if out is None:
            out = CoActivationStats(masks.shape[-1], device=device)
        out.update(masks)
    if out is None:
        if n_neurons is None:
            raise ValueError("empty shard iterator and no n_neurons given")
        out = CoActivationStats(n_neurons, device=device)
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
