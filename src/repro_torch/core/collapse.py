"""Online IOPS-friendly access collapse (paper §5.1).

Given the physical positions of the neurons to read, produce the set of
contiguous read *extents*. Two nearby runs separated by a gap of <= threshold
unactivated neurons are merged into one read (the gap is read speculatively),
trading extra bytes for fewer I/O ops — a win while the device is IOPS-bound.

Runtime control (paper §5.1):
  * AdaptiveThreshold — raises/lowers the gap threshold based on achieved
    efficiency of past collapses.
  * BottleneckDetector — disables collapse once achieved bandwidth approaches
    the device maximum (bandwidth-bound regime: extra bytes no longer free).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

Extent = Tuple[int, int]  # (start_position, length) in physical neuron units


def run_bounds_from_sorted(positions: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(start_indices, end_indices) of maximal contiguous runs in an already
    sorted-unique position array. Index arrays point INTO `positions`; the
    whole computation is one diff + two concatenates (no per-element loop).
    Shared by the read planner and the cache's segment classifier."""
    if positions.size == 0:
        empty = np.zeros(0, dtype=np.int64)
        return empty, empty
    breaks = np.nonzero(np.diff(positions) > 1)[0]
    starts = np.concatenate([[0], breaks + 1])
    ends = np.concatenate([breaks, [positions.size - 1]])
    return starts, ends


def runs_from_positions(positions: np.ndarray) -> List[Extent]:
    """Maximal contiguous runs from physical positions (sorted + deduped here)."""
    positions = np.unique(np.asarray(positions, dtype=np.int64))
    starts, ends = run_bounds_from_sorted(positions)
    return [(int(positions[s]), int(positions[e] - positions[s] + 1))
            for s, e in zip(starts, ends)]


def collapse_extents(extents: Sequence[Extent], threshold: int) -> List[Extent]:
    """Merge extents whose gap is <= threshold (gap neurons read speculatively)."""
    if not extents:
        return []
    out = [extents[0]]
    for start, length in extents[1:]:
        pstart, plength = out[-1]
        gap = start - (pstart + plength)
        if gap <= threshold:
            out[-1] = (pstart, start + length - pstart)
        else:
            out.append((start, length))
    return out


def collapse_positions(positions: np.ndarray, threshold: int) -> List[Extent]:
    return collapse_extents(runs_from_positions(positions), threshold)


@dataclasses.dataclass
class CollapseStats:
    ops_before: int = 0
    ops_after: int = 0
    useful_neurons: int = 0
    read_neurons: int = 0

    @property
    def waste_ratio(self) -> float:
        return 0.0 if self.read_neurons == 0 else 1.0 - self.useful_neurons / self.read_neurons


class AdaptiveThreshold:
    """Gap threshold anchored at the device break-even point.

    Merging a gap of g bundles is profitable iff the speculative bytes cost
    less than one I/O op:  g * bundle_bytes / B_max  <  1 / IOPS_max, i.e.

        g*  =  B_max / (IOPS_max * bundle_bytes)        (the break-even gap)

    The threshold starts at g* and adapts multiplicatively within
    [g*/2, 2 g*] from the measured op-vs-byte cost balance — the dynamic
    adjustment of paper §5.1, with the anchor keeping it from running away
    on heavily scattered layouts (where balancing alone over-merges).
    """

    def __init__(self, initial: Optional[int] = None, lo: int = 0, hi: int = 256,
                 break_even: Optional[float] = None) -> None:
        if break_even is not None:
            lo = max(int(break_even // 2), 0)
            hi = max(int(break_even * 2), 1)
        if initial is None:
            initial = max(int(break_even), 0) if break_even is not None else 4
        # an explicit initial wins over the break-even anchor, but stays inside
        # the adaptation band so one update() can't jump it across the range
        self.threshold = min(max(int(initial), lo), hi)
        self.lo, self.hi = lo, hi

    def update(self, op_cost: float, byte_cost: float) -> int:
        if op_cost > 1.25 * byte_cost:
            self.threshold = min(self.hi, max(1, self.threshold * 2))
        elif byte_cost > 1.25 * op_cost:
            self.threshold = max(self.lo, self.threshold // 2)
        return self.threshold


class BottleneckDetector:
    """Periodically checks whether achieved bandwidth saturates the device.

    When utilisation >= `saturation` the storage is bandwidth-bound and collapse
    is disabled (paper: "the system defaults to the original read strategy").
    """

    def __init__(self, device_bandwidth: float, saturation: float = 0.9, period: int = 16) -> None:
        self.device_bandwidth = device_bandwidth
        self.saturation = saturation
        self.period = period
        self._bytes = 0.0
        self._time = 0.0
        self._calls = 0
        self.collapse_enabled = True

    def record(self, nbytes: float, seconds: float) -> None:
        self._bytes += nbytes
        self._time += seconds
        self._calls += 1
        if self._calls % self.period == 0:
            achieved = self._bytes / max(self._time, 1e-12)
            self.collapse_enabled = achieved < self.saturation * self.device_bandwidth
            self._bytes = self._time = 0.0
