"""OffloadEngine — the paper's online serving pipeline for one FFN block.

Per token: predict activated neurons -> probe DRAM cache -> plan reads over the
flash layout (with access collapse) -> simulated-UFS read -> admit into cache
(linking-aligned) -> compute the sparse FFN from the bundles actually read.

Three serving granularities:
  * `step(ids)`       — one activated set (one token / one request);
  * `step_batch(ids_per_request)` — one decode *batch* from per-request id
    arrays: the activated sets of all requests are merged, the cache is
    probed once, and all misses are served by a single collapsed extent read
    (shared neurons are read once — the batching win);
  * `step_masks(masks)` — same batched step but straight from the [B, n]
    boolean activation-mask matrix the predictor produces. This is the
    serving hot path: the union, the per-request attribution
    (searchsorted/bincount-style), and the run statistics are all computed
    with array ops — no per-request or per-neuron Python iteration.

Split-phase steps (the asynchronous prefetch pipeline): `begin_step_masks`
runs the probe + read planning + collapsed read for a *speculated* mask
matrix (a lookahead prediction of the next layer's activated set, issued by
a background I/O worker while the device computes the current layer), and
`complete_step` later reconciles against the true masks — any truly
activated neuron the speculation missed is served by a synchronous top-up
read (correctness is never traded for overlap), then admission, history,
and per-request attribution happen exactly as in the one-shot step.
`step_masks` IS `complete_step(begin_step_masks(masks))`, so the split is
stats-identical to the fused step by construction.

Per-request attribution comes back columnar in `BatchStepResult`
(`req_io_seconds` etc.); `per_request` materialises the `RequestStats` view
on demand for reporting code.

The engine is deliberately deterministic and fully instrumented: every paper
figure (latency, IOPS, effective bandwidth, run lengths, cache behaviour) is
derived from `TokenStats` streams produced here.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.core.cache import make_linking_aligned_cache
from repro_torch.core.placement import PlacementResult
from repro_torch.core.storage import IOStats, ManagedReader, NeuronStore, UFSDevice
from repro_torch.obs import get_tracer


@dataclasses.dataclass
class TokenStats:
    n_activated: int = 0
    n_hits: int = 0
    n_misses: int = 0
    io: IOStats = dataclasses.field(default_factory=IOStats)
    run_lengths: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, dtype=np.int64))

    @property
    def io_seconds(self) -> float:
        return self.io.seconds


@dataclasses.dataclass
class RequestStats:
    """Per-request attribution of one batched engine step.

    The device performs ONE merged read; each request is billed a share of
    the read TIME proportional to the misses it asked for, so `io_seconds`
    always sums to exactly the merged read. A neuron missed by several
    requests splits its time cost among them — that split IS the batching
    saving, vs. each request paying for its own read in the unbatched loop.
    `bytes_useful` is different on purpose: it counts the bytes a request
    asked to have read (its own missed bundles), so summing it across
    requests double-counts shared neurons — compare it against
    `merged.io.bytes_useful` to measure exactly that sharing."""
    n_activated: int = 0
    n_hits: int = 0
    n_misses: int = 0
    io_seconds: float = 0.0
    bytes_useful: int = 0


@dataclasses.dataclass
class BatchStepResult:
    """Result of one batched step: merged payload + stats at both granularities.

    Per-request attribution is stored columnar (one array per field, row =
    request) so the serving engine can consume it without constructing
    per-request Python objects; `per_request` builds the object view lazily.
    """
    ids: np.ndarray                     # served union (activated ∪ prefetched), sorted unique
    data: Optional[np.ndarray]          # [len(ids), bundle_width] payloads
    merged: TokenStats                  # what the device actually did
    req_n_activated: np.ndarray         # [R] int
    req_n_misses: np.ndarray            # [R] int
    req_io_seconds: np.ndarray          # [R] float, sums to merged.io.seconds
    req_bytes_useful: np.ndarray        # [R] int
    # split-phase extras: neurons the lookahead speculation missed, served by
    # the synchronous top-up read (always empty on the fused path, where the
    # speculated union IS the true union and n_speculated == ids.size).
    topup_ids: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, dtype=np.int64))
    n_speculated: int = 0               # speculated-union size

    @property
    def per_request(self) -> List[RequestStats]:
        return [RequestStats(
            n_activated=int(a), n_hits=int(a) - int(m), n_misses=int(m),
            io_seconds=float(s), bytes_useful=int(b))
            for a, m, s, b in zip(self.req_n_activated, self.req_n_misses,
                                  self.req_io_seconds, self.req_bytes_useful)]

    def rows_for(self, request_ids: np.ndarray) -> np.ndarray:
        """Row indices into `data` for one request's activated ids."""
        return np.searchsorted(self.ids, np.unique(np.asarray(request_ids,
                                                              dtype=np.int64)))


@dataclasses.dataclass
class PendingStep:
    """In-flight half of a split-phase step (`begin_step_masks` output).

    Produced on the prefetch worker while the device computes the previous
    layer; consumed by `complete_step` on the serving thread. Holds exactly
    the state the complete phase needs to reconcile speculation with truth.
    """
    masks: np.ndarray          # [B, n] speculated activation masks
    union: np.ndarray          # speculated union, sorted unique
    miss_mask: np.ndarray      # over `union`: not DRAM-resident at begin time
    io: IOStats                # the speculative collapsed read (0 ops if none)
    data: Optional[np.ndarray]  # [len(union), w] payloads if requested


@dataclasses.dataclass
class EngineConfig:
    cache_ratio: float = 0.1          # fraction of neurons resident in DRAM
    collapse: bool = True             # paper §5.1
    linking_aligned_cache: bool = True  # paper §5.2
    reads_per_bundle: int = 1         # 1 = bundled (LLMFlash/RIPPLE); n_mats = llama.cpp
    # None anchors the adaptive collapse threshold at the device break-even
    # gap; an explicit value overrides the anchor (clamped to its band)
    initial_collapse_threshold: Optional[int] = None
    segment_min_len: int = 4
    segment_admit_p: float = 0.25
    cache_impl: str = "array"         # "array" (vectorized) | "dict" (reference)
    # FFN compute source for the serving runtime: "bundles" evaluates the
    # sparse FFN straight from the staged flash payloads; "segments" routes
    # through the fused segment-gather kernel (kernels/sparse_ffn.py) over
    # seg_size-aligned blocks of the permuted physical layout — exact for all
    # supported activations (covered-but-not-activated neurons are masked
    # in-kernel via the per-neuron scale tiles). "auto" promotes segments
    # when the layout is physical-placement-ordered (no identity-placement
    # layer, and the payload maps onto [n_mats * d_model] bundles) and falls
    # back to bundles otherwise; the decision is logged in io_summary().
    ffn_kernel: str = "auto"          # "auto" | "bundles" | "segments"
    kernel_seg_size: int = 128
    # Temporally faithful device emulation: actually wait out each modeled
    # flash read (a real UFS link stalls the pipeline for exactly this long —
    # DMA time, not CPU time). Off by default (pure accounting); the measured
    # prefetch benchmark turns it on for BOTH arms so serial decode stalls on
    # "flash" exactly where a phone would, and the pipelined arm's win is the
    # overlap a real device would allow.
    emulate_read_latency: bool = False


class OffloadEngine:
    """Flash-offloaded sparse-FFN serving for one FFN block."""

    def __init__(
        self,
        bundles: Optional[np.ndarray] = None,      # [n_neurons, bundle_width]
        placement: Optional[PlacementResult] = None,
        device: Optional[UFSDevice] = None,
        config: Optional[EngineConfig] = None,
        bundle_bytes: Optional[int] = None,
        *,
        store: Optional[NeuronStore] = None,
    ) -> None:
        """Either pass raw `bundles` (+ optional placement/device, defaulted by
        `NeuronStore` — the single constructor path) or a prebuilt `store`.
        The engine never re-defaults placement/device itself: `self.placement`
        and the device model are always the store's."""
        if store is None:
            self.cfg = config or EngineConfig()
            if bundles is None:
                raise ValueError("OffloadEngine needs `bundles` or `store`")
            store = NeuronStore(
                bundles, placement, device,
                reads_per_bundle=self.cfg.reads_per_bundle,
                bundle_bytes=bundle_bytes,
            )
        else:
            if any(a is not None for a in (bundles, placement, device, bundle_bytes)):
                raise ValueError(
                    "pass either a prebuilt `store` or raw bundles/placement/"
                    "device/bundle_bytes, not both — the store already fixes them")
            if config is None:   # adopt the store's layout cost model
                self.cfg = dataclasses.replace(
                    EngineConfig(), reads_per_bundle=store.reads_per_bundle)
            elif config.reads_per_bundle != store.reads_per_bundle:
                raise ValueError(
                    f"config.reads_per_bundle={config.reads_per_bundle} "
                    f"conflicts with store.reads_per_bundle={store.reads_per_bundle}")
            else:
                self.cfg = config
        self.store = store
        self.placement = store.placement
        self.reader = ManagedReader(
            self.store,
            adaptive=self.cfg.collapse,
            initial_threshold=self.cfg.initial_collapse_threshold,
        )
        self.cache = make_linking_aligned_cache(
            capacity=int(self.cfg.cache_ratio * store.n_neurons),
            n_keys=store.n_neurons,
            segment_min_len=self.cfg.segment_min_len,
            segment_admit_p=self.cfg.segment_admit_p,
            linking_aligned=self.cfg.linking_aligned_cache,
            impl=self.cfg.cache_impl,
        )
        self.history: List[TokenStats] = []

    @classmethod
    def from_store(cls, store: NeuronStore,
                   config: Optional[EngineConfig] = None) -> "OffloadEngine":
        return cls(store=store, config=config)

    # ------------------------------------------------------------------
    def _probe_and_read(self, union: np.ndarray) -> tuple[np.ndarray, IOStats]:
        """Begin-phase primitive: probe the cache for one sorted-unique set and
        serve all misses with one collapsed read. Returns (miss mask over
        `union`, read IOStats). Mutates cache hit/miss stats and the adaptive
        reader, but does NOT admit or append history — that is the
        complete-phase (`_admit_and_record`), so a background worker can run
        this ahead of time."""
        tracer = get_tracer()
        with tracer.span("probe") as sp:
            hit_mask = self.cache.lookup_mask(union)
            miss_mask = ~hit_mask
            misses = union[miss_mask]
            sp.set(n_union=int(union.size), n_misses=int(misses.size))
        io = IOStats()
        io.run_lengths = np.zeros(0, dtype=np.int64)
        if misses.size:
            with tracer.span("read") as sp:
                _, io = self.reader.read(misses, fetch_payload=False)
                if self.cfg.emulate_read_latency:
                    time.sleep(io.seconds)
                sp.set(n_misses=int(misses.size), extents=int(io.n_ops),
                       modeled_s=io.seconds, measured_s=io.measured_seconds)
        return miss_mask, io

    def predict_read_seconds(self, union: np.ndarray) -> float:
        """Modeled flash seconds serving `union` would cost RIGHT NOW, without
        serving it: peek the cache for residency (no stat/frequency bumps),
        then price the would-be miss read at the reader's current collapse
        threshold on the calibrated UFSDevice. Pure — cache, adaptive
        threshold, and history are untouched — so the server's SLO-aware
        admission gate can cost a candidate step per free slot per layer
        without perturbing the state it predicts."""
        union = np.asarray(union, dtype=np.int64)
        if union.size == 0:
            return 0.0
        resident = self.cache.peek_mask(union)
        misses = union[~resident]
        if misses.size == 0:
            return 0.0
        return self.reader.predict_seconds(misses)

    def _admit_and_record(self, n_activated: int, n_misses: int,
                          misses: np.ndarray, io: IOStats,
                          run_lengths: np.ndarray) -> TokenStats:
        """Complete-phase primitive: admit this step's missed neurons into the
        DRAM cache and record the merged TokenStats."""
        ts = TokenStats(n_activated=n_activated,
                        n_hits=n_activated - n_misses, n_misses=n_misses,
                        io=io, run_lengths=run_lengths)
        if misses.size:
            with get_tracer().span("admit", n_misses=int(misses.size)):
                self.cache.admit(misses, self.placement.physical_of(misses))
        self.history.append(ts)
        return ts

    def _serve_union(self, union: np.ndarray) -> tuple[TokenStats, np.ndarray]:
        """Probe + read + admit for one sorted-unique activated set; returns
        (merged TokenStats, miss mask over `union`)."""
        miss_mask, io = self._probe_and_read(union)
        ts = self._admit_and_record(int(union.size),
                                    int(np.count_nonzero(miss_mask)),
                                    union[miss_mask], io, io.run_lengths)
        return ts, miss_mask

    def step(self, activated_ids: np.ndarray,
             fetch_payload: bool = True) -> tuple[Optional[np.ndarray], TokenStats]:
        """Serve one token's activated-neuron set; returns (bundle data, stats).

        Returned bundles are in `activated_ids` order (cache hits are served
        from DRAM at zero I/O cost; the payload is identical either way).
        With `fetch_payload=False` the caller gathers the payload itself
        (e.g. into a reused staging buffer via `NeuronStore.fetch_into`).
        """
        ids = np.unique(np.asarray(activated_ids, dtype=np.int64))
        ts, _ = self._serve_union(ids)
        # payload for *all* activated neurons (hits came from DRAM)
        data = self.store.fetch(ids) if fetch_payload else None
        return data, ts

    # ------------------------------------------------------------------
    def step_batch(self, ids_per_request: Sequence[np.ndarray]) -> BatchStepResult:
        """Serve one decode step for a whole batch of requests.

        Activated sets are merged across requests, the cache is probed once
        per unique neuron, and all misses go out as ONE collapsed extent read
        — a neuron wanted by several requests is read (and billed to the
        device) once. `history` records the merged step, so `summary()`
        reflects real device activity; per-request attribution (hits, misses,
        proportional share of the read time) is one searchsorted + bincount
        over the concatenated id sets.
        """
        id_sets = [np.unique(np.asarray(ids, dtype=np.int64))
                   for ids in ids_per_request]
        all_ids = (np.concatenate(id_sets) if id_sets
                   else np.zeros((0,), dtype=np.int64))
        union = np.unique(all_ids)
        merged, miss_mask = self._serve_union(union)
        # per-request attribution: locate every requested id in the union,
        # look up its hit/miss status, and histogram by request
        sizes = np.array([s.size for s in id_sets], dtype=np.int64)
        req_of = np.repeat(np.arange(len(id_sets)), sizes)
        is_miss = (miss_mask[np.searchsorted(union, all_ids)] if all_ids.size
                   else np.zeros(0, dtype=bool))
        miss_counts = np.bincount(req_of, weights=is_miss,
                                  minlength=len(id_sets)).astype(np.int64)
        data = self.store.fetch(union)
        return self._attributed_result(union, data, merged, sizes, miss_counts)

    def step_masks(self, masks: np.ndarray,
                   fetch_payload: bool = True) -> BatchStepResult:
        """`step_batch` straight from the [B, n_neurons] bool mask matrix.

        The union and the per-request miss counts come from column/row
        reductions of the mask matrix — the decode inner loop never
        materialises per-request id lists. With `fetch_payload=False` the
        caller gathers payloads itself (e.g. into a reused staging buffer
        via `NeuronStore.fetch_into`) and `result.data` is None.

        Implemented as `complete_step(begin_step_masks(masks))` — the fused
        step and the split-phase pipeline share every probe/read/admit line,
        so the two are stats-identical by construction.
        """
        return self.complete_step(self.begin_step_masks(masks, fetch_payload))

    # -- split-phase (asynchronous prefetch) ---------------------------
    def begin_step_masks(self, masks: np.ndarray,
                         fetch_payload: bool = True) -> PendingStep:
        """Begin one batched step from (possibly speculative) masks: probe the
        cache and issue the single collapsed read for all misses. Safe to run
        on a background worker — admission, history, and attribution are
        deferred to `complete_step` on the serving thread. Each engine serves
        one FFN block, so a worker running layer k+1's begin phase never
        shares mutable state with layer k's complete phase.
        """
        masks = np.atleast_2d(np.asarray(masks, dtype=bool))
        union = np.flatnonzero(masks.any(axis=0))
        miss_mask, io = self._probe_and_read(union)
        data = self.store.fetch(union) if fetch_payload else None
        return PendingStep(masks=masks, union=union, miss_mask=miss_mask,
                           io=io, data=data)

    def complete_step(self, pending: PendingStep,
                      true_masks: Optional[np.ndarray] = None) -> BatchStepResult:
        """Finish a split-phase step, reconciling speculation against truth.

        With `true_masks=None` (or equal to the speculated masks) this is
        exactly the tail of the fused `step_masks`. Otherwise, truly activated
        neurons the speculation missed are probed and served by a synchronous
        top-up read — NEVER skipped — and the merged stats cover everything
        the device actually did (both reads, both probes). Admission happens
        once over all missed neurons, exactly like a fused step over the same
        set. Per-request attribution bills the combined read time by each
        request's share of truly-requested misses, so `req_io_seconds` sums
        exactly to `merged.io.seconds`; speculative over-reads that no request
        wanted are split evenly (they are the speculation's cost, not any one
        request's).
        """
        spec_miss = pending.union[pending.miss_mask]
        io, run_lengths = pending.io, pending.io.run_lengths
        n_spec_hits = int(pending.union.size) - int(spec_miss.size)
        if true_masks is None:
            masks = pending.masks
            extra = topup_miss = np.zeros(0, dtype=np.int64)
            n_extra_hits = 0
        else:
            masks = np.atleast_2d(np.asarray(true_masks, dtype=bool))
            true_union = np.flatnonzero(masks.any(axis=0))
            extra = np.setdiff1d(true_union, pending.union, assume_unique=True)
            topup_miss = np.zeros(0, dtype=np.int64)
            n_extra_hits = 0
            if extra.size:                       # lookahead under-prediction
                hit2 = self.cache.lookup_mask(extra)
                topup_miss = extra[~hit2]
                n_extra_hits = int(np.count_nonzero(hit2))
                if topup_miss.size:              # synchronous top-up read
                    with get_tracer().span("topup") as sp:
                        _, io2 = self.reader.read(topup_miss,
                                                  fetch_payload=False)
                        if self.cfg.emulate_read_latency:
                            time.sleep(io2.seconds)
                        sp.set(n_topup=int(topup_miss.size),
                               extents=int(io2.n_ops), modeled_s=io2.seconds,
                               measured_s=io2.measured_seconds)
                    io = dataclasses.replace(io)  # don't mutate the pending copy
                    io.add(io2)
                    run_lengths = np.concatenate([run_lengths, io2.run_lengths])
        all_miss = (np.concatenate([spec_miss, topup_miss]) if topup_miss.size
                    else spec_miss)
        served = int(pending.union.size) + int(extra.size)
        merged = self._admit_and_record(
            served, served - n_spec_hits - n_extra_hits, all_miss, io,
            run_lengths)
        sizes = masks.sum(axis=1, dtype=np.int64)
        # per-request misses: each request's truly-activated neurons that the
        # device had to read this step (speculated or topped up)
        if all_miss.size:
            miss_cols = np.sort(all_miss)
            miss_counts = masks[:, miss_cols].sum(axis=1, dtype=np.int64)
        else:
            miss_counts = np.zeros(masks.shape[0], dtype=np.int64)
        ids = (np.sort(np.concatenate([pending.union, extra])) if extra.size
               else pending.union)
        # keep the documented data contract ([len(ids), w] in ids order) when
        # the begin phase fetched a payload that top-ups have since widened
        data = (self.store.fetch(ids) if pending.data is not None and extra.size
                else pending.data)
        res = self._attributed_result(ids, data, merged, sizes, miss_counts)
        res.topup_ids = extra
        res.n_speculated = int(pending.union.size)
        return res

    def _attributed_result(self, union: np.ndarray, data: Optional[np.ndarray],
                           merged: TokenStats, sizes: np.ndarray,
                           miss_counts: np.ndarray) -> BatchStepResult:
        total_missed = int(miss_counts.sum())
        if total_missed:
            shares = miss_counts / total_missed
        elif merged.io.seconds > 0:
            # pure over-speculation: bytes were read but no request asked for
            # them — split the read time evenly so attribution still sums
            # exactly to the merged read
            shares = np.full(len(miss_counts), 1.0 / max(len(miss_counts), 1))
        else:
            shares = np.zeros(len(miss_counts))
        return BatchStepResult(
            ids=union, data=data, merged=merged,
            req_n_activated=sizes,
            req_n_misses=miss_counts,
            req_io_seconds=merged.io.seconds * shares,
            req_bytes_useful=(miss_counts * self.store.bundle_bytes
                              * self.store.reads_per_bundle),
        )

    # ------------------------------------------------------------------
    def run_trace(self, masks: Sequence[np.ndarray]) -> List[TokenStats]:
        """Serve a [T, n] activation-mask trace; returns per-token stats."""
        out = []
        for mask in np.atleast_2d(np.asarray(masks)):
            ids = np.nonzero(mask)[0]
            _, ts = self.step(ids)
            out.append(ts)
        return out

    # -- aggregate metrics (paper's reporting) --------------------------
    def summary(self) -> dict:
        io_s = sum(t.io.seconds for t in self.history)
        ops = sum(t.io.n_ops for t in self.history)
        useful = sum(t.io.bytes_useful for t in self.history)
        read = sum(t.io.bytes_read for t in self.history)
        n_tok = max(len(self.history), 1)
        runs = (np.concatenate([np.asarray(t.run_lengths) for t in self.history])
                if self.history else np.zeros(0, dtype=np.int64))
        return dict(
            tokens=len(self.history),
            io_seconds_per_token=io_s / n_tok,
            iops=ops / io_s if io_s else 0.0,
            ops_per_token=ops / n_tok,
            effective_bandwidth=useful / io_s if io_s else 0.0,
            raw_bandwidth=read / io_s if io_s else 0.0,
            waste_ratio=(1.0 - useful / read) if read else 0.0,
            cache_hit_rate=self.cache.stats.hit_rate,
            mean_run_length=float(np.mean(runs)) if runs.size else 0.0,
            max_run_length=int(np.max(runs)) if runs.size else 0,
        )

    def reset_stats(self) -> None:
        self.history.clear()
