"""Serving building blocks: requests/results and the flash-offloaded FFN
runtime shared by both serving front-ends.

Front-ends (see `repro_torch.serving.server` for the primary one):
  * `InferenceServer` (server.py) — slot-based continuous batching with an
    explicit request lifecycle, mid-flight admission, per-request
    retirement, and streaming.
  * `ServingEngine` (here) — the one-shot `serve()` API, a thin
    submit-all + drain wrapper over InferenceServer.

Two modes, both front-ends:
  * resident  — all weights in device memory; dense prefill/decode.
  * offload   — the paper's online stage: prefill runs dense, then every
    decode step drives, per dense-FFN layer and for the WHOLE decode batch,
        predict activated neurons (exact ReLU oracle, or trained
        predictors with `oracle=False`)
        -> one batched engine step (merged cache probe + single collapsed
           extent read over the simulated UFS layout)
        -> the FFN computed by the fused segment kernel from the
           placement-ordered flash layout (or, on an identity layout, from
           the bundle payloads actually read).

The offload mode runs the paper's I/O–compute overlap when built with
`prefetch=True`: a background I/O worker thread runs layer k+1's engine
begin phase (cache probe + collapsed read + on the bundles path the staging
gather into a double-buffered host ring) while the serving thread computes
layer k, driven by a cross-layer lookahead predictor (layer k's pre-FFN
hidden -> layer k+1's mask). The serving thread reconciles each prefetched
layer against the true mask — any mis-predicted neuron is served by a
synchronous top-up read, so pipelined decode is never less exact than
serial. The worker does host work only (numpy and the store's reads): it
touches no tensor, so it needs no device guard, stream or inference mode of
its own. What overlaps is decided by the interpreter lock: the file store's
`pread`s, numpy's larger operations and the serving thread's waits for the
card release it. `IOScheduler` reports both the analytic double-buffered
schedule and the MEASURED overlap (worker busy time vs serving-thread wait
time vs token wall clock).

Ring slots against uploads: slot `layer % 2` is refilled two layers later.
The serving thread uploads a slot with a synchronous copy from pageable
host memory, which returns only once the host buffer has been read, so the
worker never refills a slot the card may still be reading (no pinned slot,
no event to wait on; the reference's `jnp.asarray` copy is synchronous
too).

The flash layer is either in-memory `NeuronStore`s built from the model's
bundles (`build_offload_runtime`) or `FileNeuronStore`s over an on-disk
NeuronPack (`OffloadedFFNRuntime.from_pack`, `pack_path=`), whose every
collapsed extent is a real positional file read.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.engine import (BatchStepResult, EngineConfig,
                                     OffloadEngine, PendingStep)
from repro_torch.core.pipeline import IOScheduler, StageMeasurement
from repro_torch.core.placement import PlacementResult
from repro_torch.core.predictor import (PredictorParams, as_numpy_params,
                                        predict_mask, predict_mask_np,
                                        train_lookahead_predictors)
from repro_torch.core.sparse_ffn import bundle_tensor, sparse_ffn_from_bundles
from repro_torch.core.storage import NeuronStore, UFSDevice
from repro_torch.device import DeviceLike, check_same_device, resolve_device
from repro_torch.kernels import ops
from repro_torch.models import transformer
from repro_torch.models.model import Model
from repro_torch.obs import get_tracer
from repro_torch.utils import logger


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray          # [T] int32
    max_new_tokens: int = 16
    temperature: float = 0.0
    # generation stops the step any of these tokens is sampled (the stop token
    # IS included in the output); honored in resident and offload decode alike
    stop_tokens: tuple = ()
    # -- SLO surface (InferenceServer; ignored by the one-shot serve() path) --
    # admission priority class: higher admits first, and a full queue sheds
    # strictly-lower-priority queued work before rejecting a newcomer
    priority: int = 0
    # deadlines on the server's monotonic clock, None = server default/none:
    # TTFT (submit -> first token) and max inter-token gap; a blown deadline
    # retires the request with finish_reason="timeout", partial tokens kept
    ttft_slo_s: Optional[float] = None
    itl_slo_s: Optional[float] = None


@dataclasses.dataclass
class Result:
    uid: int
    tokens: List[int]
    prefill_seconds: float
    decode_seconds: float
    io_seconds: float = 0.0            # this request's attributed flash I/O
    # Modeled double-buffered decode latency summed over the decode
    # iterations this request was active in (stage compute from the measured
    # token wall apportioned by FLOPs, stage io from the UFS model).
    overlapped_seconds: float = 0.0
    # "length"  — max_new_tokens generated (the normal completion)
    # "stop"    — a stop token was sampled (included in the output)
    # "error"   — an exception retired this request (per-request isolation)
    # "timeout" — an SLO deadline (TTFT or inter-token) expired; partial
    #             tokens are preserved
    # "rejected"— backpressure: the admission queue was full at submit time,
    #             or this queued request was shed for a higher-priority
    #             arrival; no tokens were generated
    finish_reason: str = "length"
    # set iff finish_reason == "error": the exception that retired this
    # request (per-request isolation — co-batched requests keep decoding)
    error: Optional[BaseException] = None


@dataclasses.dataclass
class PrefetchedLayer:
    """One layer's staged prefetch, produced by the I/O worker: the engine's
    pending split-phase step plus where its payload sits in the staging ring."""
    layer: int
    pending: PendingStep
    k_spec: int                  # staged rows [0, k_spec) = speculated union
    io_host_seconds: float = 0.0  # measured worker wall time for this layer


class PrefetchWorker:
    """Background I/O thread (`ripple-prefetch`) for layer-ahead prefetch.

    The serving thread submits (layer, speculated masks) jobs; the worker
    runs the engine's begin phase (cache probe + read planning + collapsed
    read) and, on the bundles path, gathers the speculated union's payload
    into the runtime's double-buffered host staging ring, then posts the
    result. It touches no tensor. Jobs and results ride bounded queues
    (depth 2 = one job in flight + one queued), so a stalled consumer can
    never accumulate unbounded staged state. `Exception`s are caught per
    job on the worker and re-raised on the serving thread at `wait()` — the
    worker survives a failed job. Non-`Exception` errors (`FatalFault`,
    MemoryError-class havoc) kill the thread; the runtime's supervision in
    `complete_layer` detects the death, restarts the worker within its
    budget, and serves the affected layers through the synchronous
    fallback. `shutdown()` joins the thread.
    """

    _SENTINEL = object()

    def __init__(self, runtime: "OffloadedFFNRuntime") -> None:
        self._runtime = runtime
        self._jobs: "queue.Queue" = queue.Queue(maxsize=2)
        self._results: "queue.Queue" = queue.Queue(maxsize=2)
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="ripple-prefetch")
        self._thread.start()

    def submit(self, layer: int, masks: np.ndarray) -> None:
        self._jobs.put((layer, masks))

    def wait(self, layer: int) -> PrefetchedLayer:
        """Block until `layer`'s prefetch lands; re-raises worker exceptions.
        Raises RuntimeError promptly (sub-100ms poll) if the worker thread
        died — the supervision hook in `complete_layer` turns that into a
        restart + synchronous fallback instead of a crashed batch."""
        while True:
            try:
                kind, lay, payload = self._results.get(timeout=0.1)
                break
            except queue.Empty:
                if not self._thread.is_alive():
                    raise RuntimeError("prefetch worker died unexpectedly")
        if kind == "exc":
            raise payload
        if lay != layer:
            raise RuntimeError(f"prefetch out of order: wanted layer {layer}, "
                               f"got {lay}")
        return payload

    def _loop(self) -> None:
        while True:
            job = self._jobs.get()
            if job is self._SENTINEL:
                return
            layer, masks = job
            try:
                # span lands on the worker's own thread track, so the exported
                # trace shows layer k+1's read overlapping layer k's compute
                with get_tracer().span("prefetch", layer=layer) as sp:
                    t0 = time.perf_counter()
                    staged = self._runtime._stage_layer(layer, masks)
                    staged.io_host_seconds = time.perf_counter() - t0
                    sp.set(n_staged=staged.k_spec)
                self._results.put(("ok", layer, staged))
            except Exception as e:  # noqa: BLE001 — re-raised at wait();
                # BaseException (FatalFault & co.) deliberately falls
                # through and kills the thread: that is the worker-death
                # path supervision exists for.
                self._results.put(("exc", layer, e))

    def shutdown(self) -> None:
        """Stop and join the thread. A dead worker may leave the bounded job
        queue full, so the sentinel is put without waiting and aliveness
        re-checked: shutdown never deadlocks behind a queue nobody drains.
        While waiting for the join, stale results are drained: a worker
        whose staged results were abandoned (supervision fallback) may be
        blocked on the bounded result queue and needs a consumer to reach
        the sentinel."""
        deadline = time.monotonic() + 30.0
        sent = False
        while self._thread.is_alive() and time.monotonic() < deadline:
            if not sent:
                try:
                    self._jobs.put_nowait(self._SENTINEL)
                    sent = True
                except queue.Full:
                    pass
            try:
                self._results.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=0.05)

    @property
    def alive(self) -> bool:
        return self._thread.is_alive()


def _resolve_ffn_kernel(requested: str, placements: List[PlacementResult],
                        bundle_width: int, expected_width: int) -> tuple:
    """Resolve EngineConfig.ffn_kernel to a concrete path + human reason.

    "auto" promotes the fused segment kernel exactly when the layout can
    profit from it: every layer's placement is physical-placement-ordered
    (mode != "identity" — an identity layout carries no co-activation links,
    so segment blocks would cover mostly-inactive neurons) AND the stored
    bundle width maps onto [n_mats * d_model] weight rows (accounting-only
    stores with synthetic widths cannot be reshaped into FFN matrices).
    The segment path is exact for all supported activations: covered-but-
    not-activated neurons are masked in-kernel by the fused scale tiles.
    """
    if requested == "bundles":
        return "bundles", "explicitly requested"
    if requested == "segments":
        if bundle_width != expected_width:
            raise ValueError(
                f"ffn_kernel='segments' needs bundle_width == n_mats*d_model "
                f"({expected_width}), store has {bundle_width}")
        return "segments", "explicitly requested"
    if requested != "auto":
        raise ValueError(f"unknown ffn_kernel {requested!r}")
    if bundle_width != expected_width:
        return "bundles", (f"bundle_width {bundle_width} != n_mats*d_model "
                           f"{expected_width}: payload is not segment-mappable")
    modes = sorted({p.mode for p in placements})
    if not modes or "identity" in modes:
        return "bundles", ("identity layout: physical order carries no "
                           "co-activation links to exploit")
    return "segments", (f"physical-placement-ordered layout "
                        f"(modes: {', '.join(modes)})")


class OffloadedFFNRuntime:
    """Per-layer RIPPLE offload state: one `OffloadEngine` per dense FFN
    layer over its flash store (an in-memory `NeuronStore` over the
    simulated UFS device, or a `FileNeuronStore` over a NeuronPack), the
    placements, the activation predictors and cross-layer lookahead
    predictors, the device-resident weights of the fused segment path, and
    the prefetch worker with its double-buffered host staging ring.

    Serial decode runs each layer's engine step on the host, then its FFN
    on the device. With `start_prefetch()` the split-phase path
    (`begin_layer` / `complete_layer`) overlaps the next layer's engine
    begin phase, on the worker thread, with the current layer's compute.
    The segment path's weight matrices are uploaded to the device once, at
    construction, in physical (placement) order — the kernel gathers
    segments of them by id each step."""

    def __init__(
        self,
        cfg: ModelConfig,
        bundles_per_layer: Optional[List[np.ndarray]] = None,   # [L][n, width]
        placements: Optional[List[PlacementResult]] = None,
        predictors: Optional[List[PredictorParams]] = None,
        ufs_device: Optional[UFSDevice] = None,
        engine_cfg: Optional[EngineConfig] = None,
        lookahead: Optional[List[PredictorParams]] = None,
        lookahead_threshold: float = 0.35,
        bundle_bytes: Optional[int] = None,
        *,
        stores: Optional[List[NeuronStore]] = None,
        max_worker_restarts: int = 2,
        device: DeviceLike = None,
    ) -> None:
        """Either raw `bundles_per_layer` + `placements` (in-memory stores are
        built per layer) or prebuilt `stores` — e.g. `FileNeuronStore`s over
        a NeuronPack, the `from_pack` path. `predictors` (one per layer)
        serve `oracle=False`; `lookahead` (entry k predicts layer k+1 from
        layer k's hidden) drives speculative prefetch."""
        self.cfg = cfg
        self.device = resolve_device(device)
        self.engine_cfg = engine_cfg or EngineConfig()
        if stores is not None:
            if bundles_per_layer is not None or placements is not None:
                raise ValueError("pass either prebuilt `stores` or raw "
                                 "bundles_per_layer/placements, not both")
            self.engines = [OffloadEngine.from_store(s, config=engine_cfg)
                            for s in stores]
        else:
            if bundles_per_layer is None or placements is None:
                raise ValueError("OffloadedFFNRuntime needs bundles_per_layer"
                                 " + placements, or `stores`")
            self.engines = [
                OffloadEngine(b, placement=pl, device=ufs_device,
                              config=engine_cfg, bundle_bytes=bundle_bytes)
                for b, pl in zip(bundles_per_layer, placements)
            ]
        self.predictors = predictors
        # cross-layer lookahead: lookahead[k] predicts layer k+1's mask from
        # layer k's pre-FFN hidden state (what drives the prefetch pipeline)
        self.lookahead = lookahead
        self.lookahead_threshold = lookahead_threshold
        self.n_mats = 3 if cfg.activation == "silu" else 2
        self.ffn_kernel, self.ffn_kernel_reason = _resolve_ffn_kernel(
            self.engine_cfg.ffn_kernel,
            [e.placement for e in self.engines],
            self.engines[0].store.bundle_width if self.engines else 0,
            self.n_mats * cfg.d_model)
        # host staging buffers, keyed: the ring's two slots per (width,
        # dtype) — the worker filling one while the serving thread consumes
        # the other — plus the degraded path's own slot, scale slots, and
        # the segment path's ids and tiles (pad-bucketed, grown
        # geometrically)
        self._staging: Dict[Any, np.ndarray] = {}
        self._segment_weights: List[tuple] = (
            [self._segment_weight_mats(l) for l in range(len(self.engines))]
            if self.ffn_kernel == "segments" else [])
        self._worker: Optional[PrefetchWorker] = None
        self._lookahead_np: Optional[List[tuple]] = None
        self.topup_total = 0       # neurons served by synchronous top-up reads
        # prefetch supervision: on worker death, restart up to
        # `max_worker_restarts` times per prefetch session, then disable the
        # worker and serve every remaining layer through the synchronous
        # fallback. `worker_restarts`/`degraded_steps` are the reporting
        # counters (io_summary); `_inflight` tracks which layers have a
        # submitted-but-not-completed prefetch so completion knows whether a
        # staged result exists to wait for.
        self.max_worker_restarts = max_worker_restarts
        self.worker_restarts = 0
        self.degraded_steps = 0
        self._worker_disabled = False
        self._restarts_used = 0
        self._inflight: set = set()

    @classmethod
    def from_pack(
        cls,
        cfg: ModelConfig,
        pack,                               # path | NeuronPack
        ufs_device: Optional[UFSDevice] = None,
        engine_cfg: Optional[EngineConfig] = None,
        predictors: Optional[List[PredictorParams]] = None,
        lookahead: Optional[List[PredictorParams]] = None,
        lookahead_threshold: float = 0.35,
        verify_checksums: bool = False,
        retry=None,
        fault_plans=None,
        max_worker_restarts: int = 2,
        *,
        device: DeviceLike = None,
    ) -> "OffloadedFFNRuntime":
        """Serve straight from an on-disk NeuronPack artifact: one
        `FileNeuronStore` per layer, placements read from the pack, every
        collapsed extent a REAL positional file read. Raises ValueError when
        the pack's geometry does not match the model config (layer count,
        neuron count, bundle width).

        `verify_checksums=True` has every store check each extent read
        against the pack's per-bundle CRC32 table (v2 packs only; detected
        corruption triggers a re-read). `retry` overrides the stores'
        transient-failure `RetryPolicy`; `fault_plans` (one
        `repro_torch.store.faults.FaultPlan` per layer, None entries
        allowed) arms deterministic fault injection below the retry layer.
        The segment path's weights go to `device` (default cuda)."""
        from repro_torch.store.file_store import FileNeuronStore
        from repro_torch.store.format import NeuronPack

        device = resolve_device(device)
        pack = NeuronPack.open(pack)
        validate_pack_for_model(pack, cfg)
        ecfg = engine_cfg or EngineConfig()
        if fault_plans is not None and len(fault_plans) != pack.n_layers:
            raise ValueError(f"fault_plans covers {len(fault_plans)} layers, "
                             f"pack has {pack.n_layers}")
        stores = [FileNeuronStore(
                      pack, l, device=ufs_device,
                      reads_per_bundle=ecfg.reads_per_bundle,
                      retry=retry, verify_checksums=verify_checksums,
                      fault_plan=fault_plans[l] if fault_plans else None)
                  for l in range(pack.n_layers)]
        return cls(cfg, stores=stores, predictors=predictors,
                   engine_cfg=engine_cfg, lookahead=lookahead,
                   lookahead_threshold=lookahead_threshold,
                   max_worker_restarts=max_worker_restarts, device=device)

    # -- single merged activated set (legacy accounting interface) ----------
    def ffn_apply(self, layer: int, h: torch.Tensor,
                  oracle_mask: Optional[np.ndarray] = None):
        """h: [B, d] on the runtime's device. Returns (y [B, d], TokenStats).

        Activated set = predictor(h) if trained, else the oracle mask (exact
        ReLU support, what the paper's predictor approximates). The payload
        goes through the same staging buffers as the batched path."""
        if oracle_mask is None:
            if self.predictors is None:
                raise ValueError("ffn_apply needs trained predictors or an "
                                 "oracle mask")
            oracle_mask = predict_mask(self.predictors[layer], h).cpu().numpy()
        ids = np.nonzero(np.any(np.atleast_2d(oracle_mask), axis=0))[0]
        _, stats = self.engines[layer].step(ids, fetch_payload=False)
        return self._ffn_compute(layer, h, ids), stats

    # -- whole decode batch, per-request attribution -------------------------
    def ffn_apply_batch(
        self,
        layer: int,
        h: torch.Tensor,                            # [B, d]
        masks: Optional[np.ndarray] = None,         # [B, n_neurons] bool
    ) -> tuple[torch.Tensor, BatchStepResult]:
        """One batched engine step for all B requests' activated sets
        (`masks`, or the layer's trained predictor on `h` when None).

        Returns (y [B, d], BatchStepResult). The FFN is computed once over
        the union — rows not activated for a request contribute 0 under
        ReLU, and over-coverage from sharing neurons across requests is
        exact for the same reason."""
        if masks is None:
            if self.predictors is None:
                raise ValueError("ffn_apply_batch needs trained predictors "
                                 "or oracle masks")
            masks = predict_mask(self.predictors[layer], h).cpu().numpy()
        masks = np.atleast_2d(np.asarray(masks))
        res = self.engines[layer].step_masks(masks, fetch_payload=False)
        y = self._ffn_compute(layer, h, res.ids)
        return y, res

    # -- asynchronous layer-ahead prefetch -----------------------------------
    def start_prefetch(self) -> None:
        """Spin up a fresh I/O worker (a clean worker means no stale staged
        state can leak across serve calls). A no-op while the worker is
        supervision-disabled (restart budget exhausted mid-run): the serving
        loop re-checks `prefetch_active` every step and must NOT be allowed
        to reset the budget until the run ends (`stop_prefetch` re-arms
        it)."""
        if self._worker_disabled:
            return
        if self._worker is not None:
            self.stop_prefetch()
        self._inflight.clear()
        self._worker = PrefetchWorker(self)

    def stop_prefetch(self) -> None:
        """Shut the worker down (joining its thread) and re-arm supervision
        for the next run."""
        if self._worker is not None:
            self._worker.shutdown()
            self._worker = None
        self._inflight.clear()
        self._worker_disabled = False
        self._restarts_used = 0

    @property
    def prefetch_active(self) -> bool:
        return self._worker is not None and self._worker.alive

    def begin_layer(self, layer: int, masks: np.ndarray) -> None:
        """Submit a (possibly speculative) prefetch for `layer` to the
        worker. Degrades instead of crashing: with no live worker (never
        started, died and found dead here, or supervision-disabled) the
        submission is skipped and `complete_layer` serves the layer through
        the synchronous fallback."""
        if self._worker is not None and not self._worker.alive:
            self._handle_worker_death(
                RuntimeError("prefetch worker found dead at submit"))
        if self._worker is None:
            return
        self._worker.submit(layer, masks)
        self._inflight.add(layer)

    def predict_lookahead(self, layer: int, h_np: np.ndarray) -> np.ndarray:
        """Speculative mask for `layer + 1` from layer `layer`'s pre-FFN
        hidden state (float32 numpy on the host), evaluated in numpy on
        cached host copies of the predictor params — no device launch
        between the decode's own."""
        if self._lookahead_np is None:
            self._lookahead_np = [as_numpy_params(p) for p in self.lookahead]
        return predict_mask_np(self._lookahead_np[layer], h_np,
                               threshold=self.lookahead_threshold)

    def _stage_layer(self, layer: int, masks: np.ndarray) -> PrefetchedLayer:
        """Worker-side: engine begin phase + (bundles path) staging gather
        into ring slot `layer % 2` (consecutive layers alternate slots, so
        the serving thread's buffer is never the one the worker is
        filling). Host work only."""
        eng = self.engines[layer]
        pending = eng.begin_step_masks(masks, fetch_payload=False)
        k = int(pending.union.size)
        if self.ffn_kernel != "segments":
            self._stage_rows(eng.store, pending.union, 0, layer % 2)
        return PrefetchedLayer(layer=layer, pending=pending, k_spec=k)

    def _handle_worker_death(self, exc: BaseException) -> None:
        """Supervision: the worker thread died (non-Exception fault, OOM,
        ...). All in-flight prefetches are lost with the thread's queues;
        restart within the per-run budget, else disable the worker for the
        rest of the run (every remaining layer serves synchronously)."""
        old, self._worker = self._worker, None
        self._inflight.clear()
        if old is not None:
            old.shutdown()
        if self._restarts_used < self.max_worker_restarts:
            self._restarts_used += 1
            self.worker_restarts += 1
            logger.warning(
                "prefetch worker died (%s); restarting (%d/%d)",
                exc, self._restarts_used, self.max_worker_restarts)
            self._worker = PrefetchWorker(self)
        else:
            self._worker_disabled = True
            logger.warning(
                "prefetch worker died (%s); restart budget (%d) exhausted — "
                "decode continues on the synchronous fallback path",
                exc, self.max_worker_restarts)

    def _complete_degraded(
        self, layer: int, h: torch.Tensor, true_masks: np.ndarray,
    ) -> tuple[torch.Tensor, BatchStepResult, StageMeasurement]:
        """Synchronous fallback for a layer whose prefetch was lost (worker
        death or per-job failure): one full engine step against the TRUE
        masks plus FFN from a dedicated staging slot — the ring slots may
        still hold a live prefetch for a neighbouring layer, which must not
        be clobbered. Output is exact: the payload comes from the same store
        reads the serial path would issue."""
        t0 = time.perf_counter()
        get_tracer().instant("degraded_layer", layer=layer)
        masks = np.atleast_2d(np.asarray(true_masks))
        res = self.engines[layer].step_masks(masks, fetch_payload=False)
        y = self._ffn_compute(layer, h, res.ids, staging_slot="degraded")
        res.merged.io.degraded_steps += 1
        self.degraded_steps += 1
        meas = StageMeasurement(topup_seconds=time.perf_counter() - t0)
        return y, res, meas

    def complete_layer(
        self, layer: int, h: torch.Tensor, true_masks: np.ndarray,
    ) -> tuple[torch.Tensor, BatchStepResult, StageMeasurement]:
        """Serving-thread side: wait for `layer`'s prefetch, reconcile against
        the true masks (synchronous top-up read for lookahead misses — the
        mis-predicted payload is fetched and merged before compute, never
        skipped), and evaluate the FFN (the segment kernel over the served
        union, or the bundles from the staged ring slot).

        Fault-tolerant: a layer with no staged prefetch (worker dead /
        disabled / submission skipped), a per-job worker exception, or a
        worker death while waiting all land in `_complete_degraded` — the
        step is served synchronously and decode continues, token-identical
        whenever the underlying payload reads stay correct.
        """
        if self._worker is None or layer not in self._inflight:
            return self._complete_degraded(layer, h, true_masks)
        t0 = time.perf_counter()
        try:
            with get_tracer().span("prefetch_wait", layer=layer):
                pf = self._worker.wait(layer)
        except Exception as e:  # noqa: BLE001 — a lost prefetch degrades
            self._inflight.discard(layer)
            if self._worker is not None and not self._worker.alive:
                self._handle_worker_death(e)
            else:
                # per-job failure: the worker survived, only this layer's
                # staged read is lost; later in-flight layers stay valid.
                logger.warning("prefetch for layer %d failed (%s); serving "
                               "synchronously", layer, e)
            return self._complete_degraded(layer, h, true_masks)
        self._inflight.discard(layer)
        blocked = time.perf_counter() - t0
        eng = self.engines[layer]
        t1 = time.perf_counter()
        with get_tracer().span("topup", layer=layer) as sp:
            res = eng.complete_step(pf.pending, true_masks)
            extra = res.topup_ids
            sp.set(n_topup=int(extra.size))
            if self.ffn_kernel == "segments":
                served = (pf.pending.union if extra.size == 0
                          else np.concatenate([pf.pending.union, extra]))
            else:
                # stage the topped-up payload after the prefetched rows
                staged = self._stage_rows(eng.store, extra, pf.k_spec,
                                          layer % 2)
        topup = time.perf_counter() - t1
        self.topup_total += int(extra.size)
        y = (self._ffn_segments(layer, h, served)
             if self.ffn_kernel == "segments" else
             self._bundles_ffn(h, *staged))
        meas = StageMeasurement(io_host_seconds=pf.io_host_seconds,
                                blocked_seconds=blocked, topup_seconds=topup)
        return y, res, meas

    # activated-set sizes vary every (step, layer); the bundles path pads
    # them to a bucket so staging buffers are reused, as the reference does
    PAD_BUCKET = 128

    def _staging_buf(self, key, rows: int, tail: tuple, dtype,
                     preserve_rows: int = 0) -> np.ndarray:
        """The reused host staging buffer under `key`, of at least `rows`
        rows, grown geometrically; `preserve_rows` keeps already-staged
        leading rows across a growth reallocation (the top-up append
        path)."""
        buf = self._staging.get(key)
        if buf is None or buf.shape[0] < rows:
            size = max(rows, 2 * buf.shape[0] if buf is not None else rows)
            new = np.zeros((size,) + tail, dtype=dtype)
            if buf is not None and preserve_rows:
                new[:preserve_rows] = buf[:preserve_rows]
            buf = new
            self._staging[key] = buf
        return buf

    def _stage_rows(self, store, ids: np.ndarray, start: int, slot):
        """Gather `ids`' rows into staging `slot` after its first `start`
        staged rows and zero the pad-bucket tail; returns the staged (rows,
        scales or None, valid row count) views. Ring slots 0 and 1 (the
        serial path uses 0) are shared by all layers of equal bundle width
        and dtype; rows stay at the RAW stored dtype (int8 pack rows stay
        int8 from pread to the device) with their per-neuron dequant
        scales in a companion slot. Host work only (the worker calls
        it)."""
        k = start + int(ids.size)
        padded = -(-max(k, 1) // self.PAD_BUCKET) * self.PAD_BUCKET
        dtype = np.dtype(store.stored_dtype)
        buf = self._staging_buf(("ring", store.bundle_width, dtype, slot),
                                padded, (store.bundle_width,), dtype,
                                preserve_rows=start)
        if ids.size:
            store.fetch_into(ids, buf[start:])
        buf[k:padded] = 0
        sbuf = None
        if store.quantized:
            sbuf = self._staging_buf(("scales", slot), padded, (),
                                     np.float32, preserve_rows=start)
            if ids.size:
                store.fetch_scales_into(ids, sbuf[start:])
            sbuf[k:padded] = 0
            sbuf = sbuf[:padded]
        return buf[:padded], sbuf, k

    def _bundles_ffn(self, h: torch.Tensor, rows: np.ndarray,
                     scales: Optional[np.ndarray], k: int) -> torch.Tensor:
        """The FFN from staged bundle rows: a synchronous upload from the
        pageable slot (it returns once the host rows have been read, so the
        worker may refill the slot two layers later), the first `k` rows
        valid, int8 rows dequantized on the device."""
        padded = rows.shape[0]
        valid = torch.arange(padded, device=h.device) < k
        bundles = bundle_tensor(rows).to(h.device)
        sc = None if scales is None else torch.from_numpy(scales).to(h.device)
        return sparse_ffn_from_bundles(
            h, bundles, self.cfg.d_model, self.n_mats,
            activation=self.cfg.activation, valid_mask=valid, scales=sc)

    def _ffn_compute(self, layer: int, h: torch.Tensor, ids: np.ndarray,
                     staging_slot=0) -> torch.Tensor:
        """Dispatch the resolved FFN path for an activated-union id list.
        `staging_slot` picks the host staging slot of the bundles path: the
        degraded fallback uses its own so it can never clobber a ring slot
        holding a live neighbouring-layer prefetch."""
        if self.ffn_kernel == "segments":
            return self._ffn_segments(layer, h, ids)
        rows, scales, k = self._stage_rows(self.engines[layer].store, ids, 0,
                                           staging_slot)
        return self._bundles_ffn(h, rows, scales, k)

    # -- fused segment-gather kernel path (EngineConfig.ffn_kernel) ----------
    def _segment_weight_mats(self, layer: int) -> tuple:
        """Physical-layout weight matrices for the fused segment kernel: the
        store's RAW flash payload reshaped into [N, d] up/down(/gate)
        matrices in placement order, zero-padded to a segment multiple and
        uploaded to the device, plus the host-side per-neuron base
        multipliers (dequant scales, or 1.0 for float payloads) in physical
        order."""
        store = self.engines[layer].store
        seg = self.engine_cfg.kernel_seg_size
        d = self.cfg.d_model
        parts = np.asarray(store.physical_payload(dequantize=False)).reshape(
            store.n_neurons, self.n_mats, d)
        pad = (-store.n_neurons) % seg
        if pad:
            parts = np.concatenate(
                [parts, np.zeros((pad,) + parts.shape[1:], parts.dtype)])
        base = np.ones(store.n_neurons + pad, dtype=np.float32)
        scales = store.physical_scales()
        if scales is not None:
            base[:store.n_neurons] = scales

        def dev(a):
            return bundle_tensor(np.ascontiguousarray(a)).to(self.device)

        if self.n_mats == 3:     # bundle layout [gate | up | down]
            return dev(parts[:, 1]), dev(parts[:, 2]), dev(parts[:, 0]), base
        return dev(parts[:, 0]), dev(parts[:, 1]), None, base   # [up | down]

    def _ffn_segments(self, layer: int, h: torch.Tensor,
                      ids: np.ndarray) -> torch.Tensor:
        """FFN via the fused segment-gather kernel: the activated union maps
        to seg_size-aligned blocks of the PHYSICAL (placement-permuted)
        layout — contiguous links become few segments. Exact for every
        supported activation: each segment carries a per-neuron multiplier
        tile (dequant scale x membership in the served union) applied to the
        weight rows in-kernel, so covered-but-not-activated neurons
        contribute exactly zero. The S live segment ids go unpadded (an
        eager launch has no shape to keep stable); ids and tiles are built in
        two reused host buffers and copied to the device (two small copies
        per layer), on the serving thread only."""
        eng = self.engines[layer]
        seg = self.engine_cfg.kernel_seg_size
        w_up, w_down, w_gate, base = self._segment_weights[layer]
        phys = eng.placement.physical_of(np.asarray(ids, dtype=np.int64))
        seg_of = phys // seg
        seg_u = np.unique(seg_of)
        S = int(seg_u.size)
        id_buf = self._staging_buf("seg_ids", S, (), np.int32)
        id_buf[:S] = seg_u
        tiles = self._staging_buf(("seg_tiles", seg), S, (seg,), np.float32)
        tiles[:S] = 0.0
        rows = np.searchsorted(seg_u, seg_of)
        tiles[rows, phys % seg] = base[phys]
        seg_ids = torch.from_numpy(id_buf[:S]).to(h.device, copy=True)
        scale_tiles = torch.from_numpy(tiles[:S]).to(h.device, copy=True)
        return ops.sparse_ffn_segments_fused(
            h, w_up, w_down, seg_ids, scale_tiles, w_gate,
            seg_size=seg, activation=self.cfg.activation)

    @property
    def n_layers(self) -> int:
        return len(self.engines)

    def io_summary(self) -> dict:
        """Aggregate I/O metrics across layers.

        Ratio metrics (bandwidth, hit rate, mean run length) are computed
        from summed numerators and denominators — a mean of per-layer ratios
        would weight layers equally regardless of how much traffic each
        actually served."""
        tokens = [t for e in self.engines for t in e.history]
        io_s = sum(t.io.seconds for t in tokens)
        useful = sum(t.io.bytes_useful for t in tokens)
        hits = sum(e.cache.stats.hits for e in self.engines)
        accesses = sum(e.cache.stats.hits + e.cache.stats.misses
                       for e in self.engines)
        runs = (np.concatenate([np.asarray(t.run_lengths) for t in tokens])
                if tokens else np.zeros(0, dtype=np.int64))
        per_layer = [e.summary() for e in self.engines]
        out = {
            # resolved FFN path + why (the EngineConfig may have said "auto")
            "ffn_kernel": self.ffn_kernel,
            "ffn_kernel_decision": self.ffn_kernel_reason,
            "io_seconds_per_token": sum(s["io_seconds_per_token"]
                                        for s in per_layer),
            "mean_run_length": float(runs.mean()) if runs.size else 0.0,
            "effective_bandwidth": useful / io_s if io_s else 0.0,
            "cache_hit_rate": hits / accesses if accesses else 0.0,
            "ops_per_token": sum(s["ops_per_token"] for s in per_layer),
            # fault-tolerance counters, always present (exactly zero on the
            # clean path): retries / corrupt_extents flow up from the stores'
            # IOStats; degraded steps / worker restarts come from prefetch
            # supervision
            "retries": sum(t.io.retries for t in tokens),
            "corrupt_extents": sum(t.io.corrupt_extents for t in tokens),
            "degraded_steps": sum(t.io.degraded_steps for t in tokens),
            "worker_restarts": self.worker_restarts,
        }
        # dual accounting: wall-clock of REAL file reads, when the stores
        # perform any (FileNeuronStore over a NeuronPack) — alongside, never
        # instead of, the modeled device seconds above
        meas_ops = sum(t.io.measured_ops for t in tokens)
        if meas_ops:
            n_tok = max(max(len(e.history) for e in self.engines), 1)
            out["measured_file_seconds_per_token"] = (
                sum(t.io.measured_seconds for t in tokens) / n_tok)
            out["measured_extents_total"] = meas_ops
            out["measured_bytes_total"] = sum(t.io.measured_bytes
                                              for t in tokens)
        return out

    def predict_step_io_seconds(self, unions) -> float:
        """Modeled flash seconds one decode step serving `unions` (a per-layer
        sequence of activated-neuron id arrays, one per layer engine) would
        cost right now. Pure: delegates to each engine's
        `predict_read_seconds`. The InferenceServer's flash-I/O-aware
        admission gate sums this with its compute estimate."""
        if len(unions) != len(self.engines):
            raise ValueError(f"expected {len(self.engines)} per-layer unions, "
                             f"got {len(unions)}")
        return sum(e.predict_read_seconds(u)
                   for e, u in zip(self.engines, unions))

    def reset_stats(self) -> None:
        for e in self.engines:
            e.reset_stats()
        self.topup_total = 0
        self.worker_restarts = 0
        self.degraded_steps = 0

    def close(self) -> None:
        """Shut down the prefetch worker and close every layer store
        (releases `FileNeuronStore` fds and memmaps; a no-op for the
        in-memory store). Idempotent."""
        self.stop_prefetch()
        for e in self.engines:
            e.store.close()

    def __enter__(self) -> "OffloadedFFNRuntime":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def dense_ffn_layer_count(cfg: ModelConfig) -> int:
    """Number of dense-FFN layers the offload runtime serves (capture order:
    dense sublayers of the periodic stack prefix, times the group count)."""
    P = transformer.stack_period(cfg)
    return (cfg.n_layers // P) * sum(k == "dense"
                                     for k in cfg.ffn_kinds()[:P])


def check_pack_path(mode: str, offload) -> None:
    """`pack_path=` is an alternative to `offload=` and needs offload mode."""
    if offload is not None:
        raise ValueError("pass either `offload` or `pack_path`, not both")
    if mode != "offload":
        raise ValueError("pack_path= requires mode='offload'")


def validate_pack_for_model(pack, cfg: ModelConfig) -> None:
    """Submit-time geometry check: a NeuronPack can only serve a model whose
    dense-FFN layer count, neuron count (d_ff), and bundle width
    (n_mats * d_model) it matches. Packs built by the offline packer also
    record d_model / n_mats / activation in `meta`, which is checked when
    present — bundle_width alone cannot distinguish a [gate|up|down] silu
    bundle from an [up|down] relu bundle of 1.5x the d_model. Raises
    ValueError listing every mismatch."""
    n_mats = 3 if cfg.activation == "silu" else 2
    expected = dict(n_layers=dense_ffn_layer_count(cfg), n_neurons=cfg.d_ff,
                    bundle_width=n_mats * cfg.d_model)
    mismatches = [f"{k}: pack has {getattr(pack, k)}, model needs {v}"
                  for k, v in expected.items() if getattr(pack, k) != v]
    meta = getattr(pack, "meta", None) or {}
    mismatches += [
        f"meta.{k}: pack built for {meta[k]!r}, model is {v!r}"
        for k, v in (("d_model", cfg.d_model), ("n_mats", n_mats),
                     ("activation", cfg.activation))
        if k in meta and meta[k] != v]
    if mismatches:
        raise ValueError(
            f"NeuronPack {pack.path} does not fit this model config: "
            + "; ".join(mismatches))


class ServingEngine:
    """One-shot batch front-end, a thin compatibility wrapper:
    `serve(requests)` submits every request to a fresh `InferenceServer`
    (one slot per request) and drains it. Results come back in request
    order. `pack_path` loads the offload runtime from an on-disk NeuronPack
    (`OffloadedFFNRuntime.from_pack`, geometry-validated against the model
    config) instead of a caller-built runtime; the engine then owns it and
    closes it."""

    def __init__(self, model: Model, params: Any, max_len: int = 512,
                 swa: bool = False, mode: str = "resident",
                 offload: Optional[OffloadedFFNRuntime] = None,
                 scheduler: Optional[IOScheduler] = None,
                 oracle: bool = True, prefetch: bool = False,
                 lookahead: Union[str, List[PredictorParams], None] = None,
                 pack_path: Optional[str] = None,
                 device: DeviceLike = None):
        """`prefetch=True` runs offload decode through the asynchronous
        layer-ahead pipeline: a background I/O worker serves layer k+1's
        engine begin phase while the device computes layer k. `lookahead`
        picks the speculation source: a list of cross-layer predictor params
        (layer k's hidden -> layer k+1's mask), None to use the runtime's
        trained `lookahead` (falling back to "oracle"), or "oracle" — each
        layer's prefetch is issued with its TRUE mask (zero speculation
        depth, so no overlap, but the split-phase machinery runs
        bit-identically to serial). `oracle=False` serves every layer's
        mask from the runtime's trained predictors."""
        if mode not in ("resident", "offload"):
            raise ValueError(f"unknown serving mode {mode!r}")
        if isinstance(lookahead, str) and lookahead != "oracle":
            raise ValueError(f"unknown lookahead mode {lookahead!r}")
        self.device = resolve_device(device)
        check_same_device(self.device, model.device, "the model")
        if pack_path is not None:
            check_pack_path(mode, offload)
            offload = OffloadedFFNRuntime.from_pack(model.cfg, pack_path,
                                                    device=self.device)
        if mode == "offload" and offload is None:
            raise ValueError("mode='offload' needs an OffloadedFFNRuntime")
        self.model = model
        self.params = params
        self.max_len = max_len
        self.swa = swa
        self.mode = mode
        self.offload = offload
        self._owns_offload = pack_path is not None   # we built it: we close it
        self.oracle = oracle
        self.prefetch = prefetch
        self.lookahead = lookahead
        self.scheduler = scheduler or IOScheduler(overlap=True)

    def close(self) -> None:
        """Release the offload runtime's resources: its stores when this
        engine built the runtime itself (pack_path=), else only its prefetch
        worker (a caller's runtime stays open)."""
        if self.offload is not None:
            if self._owns_offload:
                self.offload.close()
            else:
                self.offload.stop_prefetch()

    def __enter__(self) -> "ServingEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def serve(self, requests: List[Request], seed: int = 0) -> List[Result]:
        from repro_torch.serving.server import InferenceServer
        if not requests:
            return []
        server = InferenceServer(
            self.model, self.params, max_slots=len(requests),
            max_len=self.max_len, swa=self.swa, mode=self.mode,
            offload=self.offload, scheduler=self.scheduler, oracle=self.oracle,
            prefetch=self.prefetch, lookahead=self.lookahead, seed=seed,
            device=self.device)
        try:
            handles = [server.submit(r) for r in requests]
            server.drain()
        finally:
            server.close()
        return [h.result for h in handles]


def build_offload_runtime(
    model: Model,
    params: Any,
    rng: Optional[np.random.Generator] = None,
    calib_batch: tuple = (8, 64),
    engine_cfg: Optional[EngineConfig] = None,
    ufs_device: Optional[UFSDevice] = None,
    use_placement: bool = True,
    train_lookahead: bool = False,
    lookahead_threshold: float = 0.35,
    lookahead_epochs: int = 4,
    *,
    device: DeviceLike = None,
) -> OffloadedFFNRuntime:
    """Calibrate placements from a short random-token trace and pack the
    model's dense-FFN weights into flash bundles, one engine per dense layer.

    `use_placement=False` keeps the identity layout (the LLMFlash-style
    baseline). `train_lookahead=True` additionally fits the cross-layer
    lookahead predictors (layer k's pre-FFN hidden -> layer k+1's mask) on
    the same calibration trace, enabling real speculation depth in the
    prefetch pipeline. The calibration forward, the co-activation counts
    and the predictors' training run on `device` (default cuda: the
    hiddens and masks stay on the card until the predictors are fitted);
    the counts are exact, and the placement search runs on the host in
    numpy as in the reference, so both make the same placements from the
    same masks. `ufs_device` is the simulated flash device model.
    """
    from repro_torch.core.coactivation import stats_from_masks
    from repro_torch.core.placement import identity_placement, search_placement
    from repro_torch.store.packer import extract_dense_ffn_bundles

    device = resolve_device(device)
    check_same_device(device, model.device, "the model")
    cfg = model.cfg
    if cfg.family != "dense" or cfg.is_encdec:
        raise ValueError("offload runtime covers dense decoder-only archs")
    rng = rng or np.random.default_rng(0)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, calib_batch),
                             dtype=torch.int64, device=device)
    with torch.inference_mode():
        out = model.forward(params, {"tokens": tokens},
                            capture_activations=True)
    pre_act = out["ffn_pre_act"]
    bundles = extract_dense_ffn_bundles(cfg, params)
    placements = []
    for dense_idx in range(len(bundles)):
        if use_placement:
            masks = (pre_act[dense_idx] > 0).reshape(-1, cfg.d_ff)
            placements.append(search_placement(
                stats_from_masks(masks, device=device).distance_matrix(),
                mode="auto"))
        else:
            placements.append(identity_placement(cfg.d_ff))
    n_dense = len(bundles)
    lookahead = None
    if train_lookahead and n_dense > 1:
        lookahead = train_lookahead_predictors(
            out["ffn_inputs"].reshape(n_dense, -1, cfg.d_model),
            (pre_act > 0).reshape(n_dense, -1, cfg.d_ff),
            threshold=lookahead_threshold, epochs=lookahead_epochs,
            device=device)
    del out, pre_act
    return OffloadedFFNRuntime(cfg, bundles, placements, ufs_device=ufs_device,
                               engine_cfg=engine_cfg, lookahead=lookahead,
                               lookahead_threshold=lookahead_threshold,
                               device=device)
