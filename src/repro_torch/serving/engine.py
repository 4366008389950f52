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
        exact ReLU-oracle masks
        -> one batched engine step (merged cache probe + single collapsed
           extent read over the simulated UFS layout)
        -> the FFN computed by the fused segment kernel from the
           placement-ordered flash layout (or, on an identity layout, from
           the bundle payloads actually read).

The flash layer is either in-memory `NeuronStore`s built from the model's
bundles (`build_offload_runtime`) or `FileNeuronStore`s over an on-disk
NeuronPack (`OffloadedFFNRuntime.from_pack`, `pack_path=`), whose every
collapsed extent is a real positional file read.

Not ported yet, and rejected with NotImplementedError: the asynchronous
prefetch pipeline (`prefetch=True`), trained predictors (`oracle=False`,
`predictors=`), and lookahead (`lookahead=`, lookahead training).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.engine import BatchStepResult, EngineConfig, OffloadEngine
from repro_torch.core.pipeline import IOScheduler
from repro_torch.core.placement import PlacementResult
from repro_torch.core.sparse_ffn import sparse_ffn_from_bundles
from repro_torch.core.storage import NeuronStore, UFSDevice
from repro_torch.device import DeviceLike, check_same_device, resolve_device
from repro_torch.kernels import ops
from repro_torch.models import transformer
from repro_torch.models.model import Model


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
    placements, and the device-resident weights of the fused segment path.

    The decode loop is serial: each layer's engine step runs on the host,
    then its FFN runs on the device. The segment path's weight matrices are
    uploaded to the device once, at construction, in physical (placement)
    order — the kernel gathers segments of them by id each step."""

    def __init__(
        self,
        cfg: ModelConfig,
        bundles_per_layer: Optional[List[np.ndarray]] = None,   # [L][n, width]
        placements: Optional[List[PlacementResult]] = None,
        ufs_device: Optional[UFSDevice] = None,
        engine_cfg: Optional[EngineConfig] = None,
        bundle_bytes: Optional[int] = None,
        *,
        stores: Optional[List[NeuronStore]] = None,
        device: DeviceLike = None,
    ) -> None:
        """Either raw `bundles_per_layer` + `placements` (in-memory stores are
        built per layer) or prebuilt `stores` — e.g. `FileNeuronStore`s over
        a NeuronPack, the `from_pack` path."""
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
        self.n_mats = 3 if cfg.activation == "silu" else 2
        self.ffn_kernel, self.ffn_kernel_reason = _resolve_ffn_kernel(
            self.engine_cfg.ffn_kernel,
            [e.placement for e in self.engines],
            self.engines[0].store.bundle_width if self.engines else 0,
            self.n_mats * cfg.d_model)
        # reused host staging buffers (pad-bucketed, grown geometrically)
        self._staging: Dict[Any, np.ndarray] = {}
        self._segment_weights: List[tuple] = (
            [self._segment_weight_mats(l) for l in range(len(self.engines))]
            if self.ffn_kernel == "segments" else [])

    @classmethod
    def from_pack(
        cls,
        cfg: ModelConfig,
        pack,                               # path | NeuronPack
        ufs_device: Optional[UFSDevice] = None,
        engine_cfg: Optional[EngineConfig] = None,
        predictors=None,
        lookahead=None,
        verify_checksums: bool = False,
        retry=None,
        fault_plans=None,
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
        The segment path's weights go to `device` (default cuda).
        `predictors` and `lookahead` raise NotImplementedError (their slice
        is not ported)."""
        from repro_torch.store.file_store import FileNeuronStore
        from repro_torch.store.format import NeuronPack

        if predictors is not None or lookahead is not None:
            raise NotImplementedError("predictors= and lookahead= are not "
                                      "ported to PyTorch yet")
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
        return cls(cfg, stores=stores, engine_cfg=engine_cfg, device=device)

    # -- whole decode batch, per-request attribution -------------------------
    def ffn_apply_batch(
        self,
        layer: int,
        h: torch.Tensor,                           # [B, d]
        masks: np.ndarray,                         # [B, n_neurons] bool
    ) -> tuple[torch.Tensor, BatchStepResult]:
        """One batched engine step for all B requests' activated sets.

        Returns (y [B, d], BatchStepResult). The FFN is computed once over
        the union — rows not activated for a request contribute 0 under
        ReLU, and over-coverage from sharing neurons across requests is
        exact for the same reason."""
        masks = np.atleast_2d(np.asarray(masks))
        res = self.engines[layer].step_masks(masks, fetch_payload=False)
        y = self._ffn_compute(layer, h, res.ids)
        return y, res

    # activated-set sizes vary every (step, layer); the bundles path pads
    # them to a bucket so staging buffers are reused, as the reference does
    PAD_BUCKET = 128

    def _staging_buf(self, key, rows: int, tail: tuple, dtype) -> np.ndarray:
        """Reused host staging buffer of at least `rows` rows, grown
        geometrically, shared by every layer that asks with the same key."""
        buf = self._staging.get(key)
        if buf is None or buf.shape[0] < rows:
            size = max(rows, 2 * buf.shape[0] if buf is not None else rows)
            buf = np.zeros((size,) + tail, dtype=dtype)
            self._staging[key] = buf
        return buf

    def _ffn_compute(self, layer: int, h: torch.Tensor,
                     ids: np.ndarray) -> torch.Tensor:
        """Dispatch the resolved FFN path for an activated-union id list."""
        if self.ffn_kernel == "segments":
            return self._ffn_segments(layer, h, ids)
        return self._ffn_from_ids(layer, h, ids)

    def _ffn_from_ids(self, layer: int, h: torch.Tensor,
                      ids: np.ndarray) -> torch.Tensor:
        store = self.engines[layer].store
        k = int(ids.size)
        padded = -(-max(k, 1) // self.PAD_BUCKET) * self.PAD_BUCKET
        buf = self._staging_buf(("bundles", store.bundle_width,
                                  store.stored_dtype), padded,
                                 (store.bundle_width,), store.stored_dtype)
        store.fetch_into(ids, buf)
        buf[k:padded] = 0
        valid = torch.arange(padded, device=h.device) < k
        bundles = torch.from_numpy(buf[:padded]).to(h.device)
        return sparse_ffn_from_bundles(
            h, bundles, self.cfg.d_model, self.n_mats,
            activation=self.cfg.activation, valid_mask=valid)

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
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

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
        per layer)."""
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
            # IOStats; no prefetch worker runs yet, so nothing restarts
            "retries": sum(t.io.retries for t in tokens),
            "corrupt_extents": sum(t.io.corrupt_extents for t in tokens),
            "degraded_steps": sum(t.io.degraded_steps for t in tokens),
            "worker_restarts": 0,
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

    def close(self) -> None:
        """Close every layer store (releases `FileNeuronStore` fds and
        memmaps; a no-op for the in-memory store). Idempotent."""
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


def reject_unported(*, prefetch: bool = False, oracle: bool = True) -> None:
    """Raise NotImplementedError for serving options whose slice has not
    landed in the port yet (they are never silently ignored)."""
    unported = [(prefetch, "the prefetch pipeline (prefetch=True)"),
                (not oracle, "trained predictors (oracle=False)")]
    for hit, what in unported:
        if hit:
            raise NotImplementedError(f"{what} is not ported to PyTorch yet")


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
                 pack_path: Optional[str] = None,
                 device: DeviceLike = None):
        if mode not in ("resident", "offload"):
            raise ValueError(f"unknown serving mode {mode!r}")
        reject_unported(prefetch=prefetch, oracle=oracle)
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
        self.scheduler = scheduler or IOScheduler(overlap=True)

    def close(self) -> None:
        """Close the offload runtime's layer stores when this engine built
        the runtime itself (pack_path=); a caller's runtime stays open."""
        if self.offload is not None and self._owns_offload:
            self.offload.close()

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
            offload=self.offload, scheduler=self.scheduler, seed=seed,
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
    *,
    device: DeviceLike = None,
) -> OffloadedFFNRuntime:
    """Calibrate placements from a short random-token trace and pack the
    model's dense-FFN weights into flash bundles, one engine per dense layer.

    `use_placement=False` keeps the identity layout (the LLMFlash-style
    baseline). The calibration forward and the co-activation counts run on
    `device` (default cuda: the masks stay on the card and go through the
    coact kernel); the counts are exact, and the placement search runs on
    the host in numpy as in the reference, so both make the same placements
    from the same masks. `ufs_device` is the simulated flash device model.
    """
    from repro_torch.core.coactivation import stats_from_masks
    from repro_torch.core.placement import identity_placement, search_placement
    from repro_torch.store.packer import extract_dense_ffn_bundles

    if train_lookahead:
        raise NotImplementedError("lookahead predictor training is not "
                                  "ported to PyTorch yet")
    device = resolve_device(device)
    check_same_device(device, model.device, "the model")
    cfg = model.cfg
    if cfg.family != "dense" or cfg.is_encdec:
        raise ValueError("offload runtime covers dense decoder-only archs")
    rng = rng or np.random.default_rng(0)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, calib_batch),
                             dtype=torch.int64, device=device)
    with torch.inference_mode():
        pre_act = model.forward(params, {"tokens": tokens},
                                capture_activations=True)["ffn_pre_act"]
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
    del pre_act
    return OffloadedFFNRuntime(cfg, bundles, placements, ufs_device=ufs_device,
                               engine_cfg=engine_cfg, device=device)
