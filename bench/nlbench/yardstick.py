"""The benchmark's frozen arithmetic: the flash device's price of a read,
the chip's published peaks, and percentiles.

`UFS40` is a copy of the UFS 4.0 model the paper's runtime is priced on
(`repro_torch/core/storage.py` UFS40, OnePlus 12 / Ace 3: 150,000 IOPS,
3.6 GB/s, 40 us a read), frozen here so that no change to the program
moves the yardstick. A read of n extents and b bytes takes
40 us + n / 150,000 s + b / 3.6e9 s; a read of nothing takes 0.

Peaks are NVIDIA's data-sheet rates of one H100 SXM (dense, no sparsity)
at its full 700 W power limit.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

UFS40_IOPS = 150_000.0
UFS40_BYTES_PER_S = 3.6e9
UFS40_BASE_S = 40e-6

H100_BF16_FLOPS = 989e12
H100_FP32_FLOPS = 67e12
H100_HBM_BYTES_PER_S = 3.35e12


def ufs40_read_seconds(n_ops: int, n_bytes: int) -> float:
    """Seconds one read call of `n_ops` extents and `n_bytes` bytes takes
    on the UFS 4.0 model."""
    if n_ops == 0:
        return 0.0
    return UFS40_BASE_S + n_ops / UFS40_IOPS + n_bytes / UFS40_BYTES_PER_S


def roofline_seconds(flops: float, nbytes: float, flops_per_s: float,
                     bytes_per_s: float = H100_HBM_BYTES_PER_S) -> float:
    """The least time the chip could take: the larger of the operations
    over the peak rate and the bytes over the memory rate."""
    return max(flops / flops_per_s, nbytes / bytes_per_s)


def p95(values: Sequence[float]) -> float:
    if len(values) == 0:
        raise ValueError("no samples in the window for a 95th percentile: "
                         "the window is too short for this traffic")
    return float(np.percentile(np.asarray(values, dtype=np.float64), 95))
