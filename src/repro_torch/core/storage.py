"""Simulated UFS flash device + placement-aware neuron store.

The paper's runtime reads neuron bundles from UFS flash. This container has no
UFS device, so I/O cost comes from a calibrated device model implementing the
paper's Figure-4 law: effective bandwidth grows ~linearly with continuous I/O
size until the IOPS x io_size product reaches the link bandwidth (crossover at
~24 KB for UFS 4.0), then flattens. The additive form

    T(batch) = n_ops / IOPS_max + total_bytes / B_max        (+ fixed base)

reproduces exactly that curve and both asymptotes. The *algorithms* (placement,
collapse, caching) are the paper's, bit-for-bit; only the device is a model.

`NeuronStore` owns the physical layout of one FFN block's neuron bundles and
serves logical-id reads as contiguous extent reads, with optional access
collapse. Actual bundle payloads are backed by a numpy array so the serving
path computes with the very bytes it "read".
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.collapse import (AdaptiveThreshold, BottleneckDetector, Extent,
                                 collapse_extents, run_bounds_from_sorted,
                                 runs_from_positions)
from repro_torch.core.placement import PlacementResult, identity_placement


# -- device models ----------------------------------------------------------

UFS40 = dict(iops_max=150_000.0, bandwidth_max=3.6e9, base_latency=40e-6)   # OnePlus 12 / Ace 3
UFS31 = dict(iops_max=90_000.0, bandwidth_max=1.9e9, base_latency=60e-6)    # OnePlus Ace 2


@dataclasses.dataclass
class UFSDevice:
    """Additive IOPS + bandwidth latency model (paper Fig. 4)."""

    iops_max: float = UFS40["iops_max"]
    bandwidth_max: float = UFS40["bandwidth_max"]
    base_latency: float = UFS40["base_latency"]

    def read_time(self, n_ops: int, total_bytes: int) -> float:
        if n_ops == 0:
            return 0.0
        return self.base_latency + n_ops / self.iops_max + total_bytes / self.bandwidth_max

    def crossover_bytes(self) -> float:
        """Continuous I/O size where IOPS cost == byte cost (~24 KB for UFS4.0)."""
        return self.bandwidth_max / self.iops_max

    def bandwidth_at_io_size(self, io_size_bytes: float, queue_depth: int = 32) -> float:
        """Achieved bandwidth when streaming reads of a fixed size (Fig. 4)."""
        t = self.read_time(queue_depth, int(io_size_bytes * queue_depth))
        return queue_depth * io_size_bytes / t


@dataclasses.dataclass
class IOStats:
    n_ops: int = 0
    bytes_read: int = 0
    bytes_useful: int = 0
    seconds: float = 0.0
    n_requests: int = 0
    # Measured (wall-clock) accounting for stores that perform REAL reads
    # (`repro_torch.store.FileNeuronStore`): what the filesystem actually did,
    # recorded alongside — never instead of — the calibrated UFS model above.
    # In-memory stores leave all three at zero.
    measured_ops: int = 0
    measured_bytes: int = 0
    measured_seconds: float = 0.0
    # Fault-tolerance accounting (repro_torch.store.faults): `retries` counts
    # re-issued extent reads (transient-error retry or checksum-triggered
    # re-read), `corrupt_extents` counts CRC mismatches detected by the
    # opt-in verification mode, and `degraded_steps` marks engine steps the
    # prefetch pipeline served through the synchronous fallback after a
    # worker failure. All three stay zero on the clean path — the CI chaos
    # gate asserts exactly that.
    retries: int = 0
    corrupt_extents: int = 0
    degraded_steps: int = 0
    # pre-collapse run lengths of the requested neurons in flash order — a
    # by-product of read planning (the positions are already sorted there),
    # recorded so callers don't re-derive runs from scratch. Per-read only:
    # `add` resets it to None (see below).
    run_lengths: Optional[np.ndarray] = dataclasses.field(
        default=None, repr=False, compare=False)

    def add(self, other: "IOStats") -> None:
        """Aggregate counters. `run_lengths` is a per-read by-product, not an
        aggregate: merging two reads' runs element-wise is meaningless, and
        silently keeping `self`'s array would hand callers a stale view of
        only the FIRST read. The contract is therefore that an aggregated
        IOStats never carries run lengths — `add` explicitly clears them;
        callers that want runs across reads concatenate them per read (as the
        engine's split-phase step does)."""
        self.n_ops += other.n_ops
        self.bytes_read += other.bytes_read
        self.bytes_useful += other.bytes_useful
        self.seconds += other.seconds
        self.n_requests += other.n_requests
        self.measured_ops += other.measured_ops
        self.measured_bytes += other.measured_bytes
        self.measured_seconds += other.measured_seconds
        self.retries += other.retries
        self.corrupt_extents += other.corrupt_extents
        self.degraded_steps += other.degraded_steps
        self.run_lengths = None

    @property
    def effective_bandwidth(self) -> float:
        """Paper's metric: *useful* (activated) bytes per second."""
        return self.bytes_useful / self.seconds if self.seconds > 0 else 0.0

    @property
    def raw_bandwidth(self) -> float:
        return self.bytes_read / self.seconds if self.seconds > 0 else 0.0

    @property
    def iops(self) -> float:
        return self.n_ops / self.seconds if self.seconds > 0 else 0.0

    @property
    def measured_bandwidth(self) -> float:
        """Real bytes actually read per real second — only meaningful for
        file-backed stores; 0.0 on the pure device model."""
        return (self.measured_bytes / self.measured_seconds
                if self.measured_seconds > 0 else 0.0)


class NeuronStore:
    """Flash-resident neuron bundles for one FFN block under a physical layout.

    data: [n_neurons, bundle_width] — bundle i holds the gate/up rows + down
    column for neuron i, flattened. Physical layout is data[placement], i.e.
    physical slot p stores logical neuron placement[p].
    """

    # In-memory stores hold the payload at its serving dtype; quantized
    # subclasses (FileNeuronStore over an int8 pack) override these.
    quantized: bool = False

    def __init__(
        self,
        data: np.ndarray,
        placement: Optional[PlacementResult] = None,
        device: Optional[UFSDevice] = None,
        reads_per_bundle: int = 1,
        bundle_bytes: Optional[int] = None,
    ) -> None:
        self.n_neurons, self.bundle_width = data.shape
        self.placement = placement or identity_placement(self.n_neurons)
        self.device = device or UFSDevice()
        # llama.cpp stores each weight matrix separately -> an activated neuron
        # costs `reads_per_bundle` scattered ops (2 for OPT, 3 for Llama).
        # Bundled layouts (LLMFlash, RIPPLE) use 1.
        self.reads_per_bundle = reads_per_bundle
        # bundle_bytes may exceed the backing payload width (accounting-only
        # runs with huge bundles, e.g. MoE experts, pass a small payload).
        self.bundle_bytes = (int(bundle_bytes) if bundle_bytes
                             else int(self.bundle_width * data.dtype.itemsize))
        self._phys_data = np.ascontiguousarray(data[self.placement.placement])

    # -- payload surface -----------------------------------------------------
    @property
    def payload_dtype(self) -> np.dtype:
        """dtype of the bundle payloads this store SERVES by default
        (file-backed int8 packs store int8 but `fetch` dequantizes to
        float32 unless the caller asks for the raw dtype)."""
        return self._phys_data.dtype

    @property
    def stored_dtype(self) -> np.dtype:
        """Raw on-media dtype — equals payload_dtype unless the store
        quantizes. Dtype-faithful staging allocates ring slots at this dtype
        so int8 pack rows never become float32 on the host."""
        return self._phys_data.dtype

    def physical_payload(self, dequantize: bool = True) -> np.ndarray:
        """Full [n_neurons, bundle_width] payload in PHYSICAL (placement)
        order — the segment-kernel weight source. Zero modelled I/O.
        dequantize=False returns the raw stored dtype (a no-op here; int8
        file stores return the raw memmap rows)."""
        return self._phys_data

    def physical_scales(self) -> Optional[np.ndarray]:
        """Per-neuron dequant scales in PHYSICAL order, or None for float
        payloads (consumers then use an implicit scale of 1.0)."""
        return None

    def fetch_scales_into(self, logical_ids: np.ndarray, out: np.ndarray) -> np.ndarray:
        """Gather per-neuron scales for logical ids into `out[:k]` (the
        staged companion of `fetch_into` on quantized stores)."""
        raise RuntimeError("store is not quantized: no scales to fetch")

    # -- zero-cost payload access -------------------------------------------
    def fetch(self, logical_ids: np.ndarray) -> np.ndarray:
        """Bundle payloads for logical ids, in id order, at zero modelled I/O.

        This is the DRAM-side read: callers use it for neurons whose bytes are
        already resident (cache hits, or bytes just admitted by `read`). It is
        the public replacement for poking `_phys_data` directly — the serving
        engine accounts flash I/O exclusively through `read`/`ManagedReader`
        and serves every payload through this method.
        """
        logical_ids = np.asarray(logical_ids, dtype=np.int64)
        if logical_ids.size == 0:
            return np.zeros((0, self.bundle_width), dtype=self.payload_dtype)
        return self._phys_data[self.placement.physical_of(logical_ids)]

    def fetch_into(self, logical_ids: np.ndarray, out: np.ndarray) -> np.ndarray:
        """`fetch` into a caller-provided buffer (no allocation): the serving
        engine keeps one padded host staging buffer per layer and gathers
        bundle payloads straight into it, so the decode loop performs a
        single buffer fill + one host-to-device transfer per layer."""
        logical_ids = np.asarray(logical_ids, dtype=np.int64)
        if logical_ids.size:
            np.take(self._phys_data, self.placement.physical_of(logical_ids),
                    axis=0, out=out[:logical_ids.size])
        return out

    # -- read planning -------------------------------------------------------
    def _plan(self, phys: np.ndarray,
              collapse_threshold: int) -> Tuple[List[Extent], np.ndarray]:
        """(read extents, pre-collapse run lengths) from physical positions."""
        phys_sorted = np.unique(phys)
        starts, ends = run_bounds_from_sorted(phys_sorted)
        extents = [(int(phys_sorted[s]), int(phys_sorted[e] - phys_sorted[s] + 1))
                   for s, e in zip(starts, ends)]
        run_lengths = (phys_sorted[ends] - phys_sorted[starts] + 1
                       if starts.size else np.zeros(0, dtype=np.int64))
        if collapse_threshold > 0:
            extents = collapse_extents(extents, collapse_threshold)
        return extents, run_lengths

    def plan_extents(self, logical_ids: np.ndarray, collapse_threshold: int = 0) -> List[Extent]:
        phys = self.placement.physical_of(np.asarray(logical_ids, dtype=np.int64))
        extents, _ = self._plan(phys, collapse_threshold)
        return extents

    def read(self, logical_ids: np.ndarray, collapse_threshold: int = 0,
             fetch_payload: bool = True) -> Tuple[Optional[np.ndarray], IOStats]:
        """Read bundles for logical ids; returns (data [k, w] in id order, stats).

        `stats.run_lengths` carries the pre-collapse run lengths (the maximal
        contiguous runs of the requested neurons in flash order) — computed
        here once from the already-sorted positions instead of by callers.
        `fetch_payload=False` skips materialising the payload (data is None):
        the engine's probe/read accounting path discards it anyway because the
        full activated-union payload — hits included — is gathered separately
        into a staging buffer via `fetch_into`.
        """
        logical_ids = np.asarray(logical_ids, dtype=np.int64)
        stats = IOStats(n_requests=1)
        if logical_ids.size == 0:
            stats.run_lengths = np.zeros(0, dtype=np.int64)
            empty = (np.zeros((0, self.bundle_width), dtype=self.payload_dtype)
                     if fetch_payload else None)
            return empty, stats
        phys = self.placement.physical_of(logical_ids)
        extents, stats.run_lengths = self._plan(phys, collapse_threshold)
        n_read = sum(length for _, length in extents)
        n_unique = int(stats.run_lengths.sum())   # runs partition unique ids
        stats.n_ops = len(extents) * self.reads_per_bundle
        stats.bytes_read = n_read * self.bundle_bytes * self.reads_per_bundle
        stats.bytes_useful = n_unique * self.bundle_bytes * self.reads_per_bundle
        stats.seconds = self.device.read_time(stats.n_ops, stats.bytes_read)
        data = self._serve_extents(extents, phys, fetch_payload, stats)
        return data, stats

    def _serve_extents(self, extents: List[Extent], phys: np.ndarray,
                       fetch_payload: bool,
                       stats: IOStats) -> Optional[np.ndarray]:
        """Payload-materialisation hook behind `read`'s accounting.

        The in-memory store serves straight from the DRAM-backed physical
        array — the extent plan affects accounting only, and the payload is
        identical regardless of it. File-backed stores
        (`repro_torch.store.FileNeuronStore`) override this to issue one REAL
        positional file read per collapsed extent and record the measured_*
        fields on `stats` (the read happens even with `fetch_payload=False`:
        the extent reads ARE the I/O; only the row-gathered payload array is
        skipped)."""
        del extents, stats
        return self._phys_data[phys] if fetch_payload else None

    def close(self) -> None:
        """Release any backing resources. The in-memory store holds none —
        this no-op anchors the lifecycle contract so runtimes can close
        every store uniformly (`FileNeuronStore` overrides it to release
        its fd and memmap)."""


class ManagedReader:
    """Read path with adaptive collapse + bottleneck detection (paper §5.1)."""

    def __init__(self, store: NeuronStore, adaptive: bool = True,
                 initial_threshold: Optional[int] = None) -> None:
        """`initial_threshold=None` starts at the device break-even gap; an
        explicit value wins over the anchor (clamped to the adaptation band,
        which stays break-even-derived either way)."""
        self.store = store
        self.adaptive = adaptive
        break_even = store.device.bandwidth_max / (
            store.device.iops_max * max(store.bundle_bytes, 1))
        self.threshold = AdaptiveThreshold(initial=initial_threshold,
                                           break_even=break_even)
        self.detector = BottleneckDetector(store.device.bandwidth_max)
        self.total = IOStats()

    def read(self, logical_ids: np.ndarray,
             fetch_payload: bool = True) -> Tuple[Optional[np.ndarray], IOStats]:
        thr = self.threshold.threshold if (self.adaptive and self.detector.collapse_enabled) else 0
        data, stats = self.store.read(logical_ids, collapse_threshold=thr,
                                      fetch_payload=fetch_payload)
        if self.adaptive and stats.n_ops:
            op_cost = stats.n_ops / self.store.device.iops_max
            byte_cost = stats.bytes_read / self.store.device.bandwidth_max
            self.threshold.update(op_cost, byte_cost)
            self.detector.record(stats.bytes_read, stats.seconds)
        self.total.add(stats)
        return data, stats

    def predict_seconds(self, logical_ids: np.ndarray) -> float:
        """Modeled seconds a `read(logical_ids)` would cost RIGHT NOW, without
        issuing it: plan extents at the current adaptive threshold, apply the
        store's op/byte accounting, and price it on the calibrated UFSDevice.
        Pure — no threshold update, no detector sample, no `total` accrual —
        so SLO-aware admission (serving/server.py) can cost candidate steps
        as often as it likes without steering the adaptation it predicts."""
        logical_ids = np.asarray(logical_ids, dtype=np.int64)
        if logical_ids.size == 0:
            return 0.0
        thr = self.threshold.threshold if (self.adaptive and self.detector.collapse_enabled) else 0
        extents = self.store.plan_extents(logical_ids, collapse_threshold=thr)
        n_read = sum(length for _, length in extents)
        n_ops = len(extents) * self.store.reads_per_bundle
        bytes_read = n_read * self.store.bundle_bytes * self.store.reads_per_bundle
        return self.store.device.read_time(n_ops, bytes_read)
