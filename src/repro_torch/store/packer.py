"""Offline NeuronPack packer — the paper's offline stage, end to end, into a
deployable artifact, on the port's device.

    trace FFN activations on the device (masks streamed to disk shards)
      -> CoActivationStats per dense layer on the device (the coact kernel
         on CUDA; shard-merged, bounded memory)
      -> greedy linked-placement search on the host (Algorithm 1, numpy)
      -> serialize bundles in physical order (`store.format.write_pack`)

The resulting file is everything the online stage needs to serve from
flash: `FileNeuronStore` opens it per layer, and
`OffloadedFFNRuntime.from_pack` wires it into the serving runtime.
`launch/pack.py` is its command line. From the same weights and
calibration seed it makes the reference packer's placements, bundles,
scales and CRCs.
"""
from __future__ import annotations

import dataclasses
import tempfile
import time
from typing import List, Optional

import numpy as np

from repro_torch.device import DeviceLike, check_same_device, resolve_device


def extract_dense_ffn_bundles(cfg, params) -> List[np.ndarray]:
    """Per dense-FFN layer, the [n_neurons, bundle_width] flash bundles (host
    numpy) in LOGICAL neuron order, enumerated in the same (group, sublayer)
    order as `ffn_pre_act` capture."""
    from repro_torch.core.sparse_ffn import FFNWeights, make_bundles
    from repro_torch.models import transformer

    P = transformer.stack_period(cfg)
    ffns = cfg.ffn_kinds()
    bundles = []
    for group in params["stack"]:
        for j in range(P):
            if ffns[j] != "dense":
                continue
            ffn_p = group[f"sub_{j}"]["ffn"]
            w = FFNWeights(
                w_up=ffn_p["w_up"].T, w_down=ffn_p["w_down"],
                w_gate=(ffn_p["w_gate"].T if "w_gate" in ffn_p else None))
            bundles.append(make_bundles(w))
    return bundles


def trace_to_shards(model, params, token_batches, writer,
                    sparsity_topk: Optional[int] = None) -> int:
    """Run the model over token batches on its device, appending each
    batch's per-layer activation masks to the shard writer (the masks come
    to the host once per batch, to be written; nothing accumulates in RAM).
    Returns the number of tokens traced."""
    from repro_torch.core.trace import batch_masks

    total = 0
    for tokens in token_batches:
        masks = batch_masks(model, params, tokens, sparsity_topk).cpu().numpy()
        for l in range(masks.shape[0]):
            writer.append(l, masks[l])
        total += int(np.prod(np.asarray(tokens).shape))
    return total


@dataclasses.dataclass
class PackBuildReport:
    path: str
    n_layers: int
    n_neurons: int
    bundle_width: int
    quantized: bool
    file_bytes: int
    tokens_traced: int
    search_seconds: float              # summed over layers
    placement_mode: str
    build_seconds: float
    # the split of build_seconds: the traced forward passes and shard writes,
    # the co-activation counts (shards read back, counted on the device, the
    # distance matrix on the host), the write of the pack file
    trace_seconds: float = 0.0
    counts_seconds: float = 0.0
    write_seconds: float = 0.0


def build_pack(
    model,
    params,
    out_path,
    *,
    calib_tokens: int = 512,
    calib_batch: int = 8,
    calib_seqlen: int = 64,
    seed: int = 0,
    use_placement: bool = True,
    placement_mode: str = "auto",
    quantize: str = "none",
    shard_dir=None,
    sparsity_topk: Optional[int] = None,
    meta: Optional[dict] = None,
    pack_version: Optional[int] = None,
    device: DeviceLike = None,
) -> PackBuildReport:
    """The full offline stage for one model: calibration trace -> linked
    placement per dense layer -> NeuronPack on disk.

    Runs on `device` (default cuda; the model must live there). The
    calibration stream is random tokens from `np.random.default_rng(seed)`
    (the co-activation structure is model-intrinsic, paper Fig. 15);
    `shard_dir=None` stages trace shards in a temporary directory that is
    deleted after the stats pass.
    """
    from repro_torch.core.coactivation import stats_from_mask_shards
    from repro_torch.core.placement import (identity_placement,
                                            search_placement)
    from repro_torch.core.trace import ShardedTraceWriter, iter_trace_shards
    from repro_torch.store.format import write_pack

    device = resolve_device(device)
    check_same_device(device, model.device, "the model")
    cfg = model.cfg
    if cfg.family != "dense" or cfg.is_encdec:
        raise ValueError("NeuronPack packing covers dense decoder-only archs")
    t_start = time.perf_counter()
    bundles = extract_dense_ffn_bundles(cfg, params)
    rng = np.random.default_rng(seed)

    def batches():
        done = 0
        while done < calib_tokens:
            yield rng.integers(0, cfg.vocab_size,
                               (calib_batch, calib_seqlen)).astype(np.int32)
            done += calib_batch * calib_seqlen

    tmp = None
    if shard_dir is None:
        tmp = tempfile.TemporaryDirectory(prefix="npack-trace-")
        shard_dir = tmp.name
    counts_s = 0.0
    try:
        t0 = time.perf_counter()
        writer = ShardedTraceWriter(shard_dir, n_layers=len(bundles),
                                    n_neurons=cfg.d_ff)
        traced = trace_to_shards(model, params, batches(), writer,
                                 sparsity_topk=sparsity_topk)
        writer.finish()
        trace_s = time.perf_counter() - t0
        placements = []
        for l in range(len(bundles)):
            if use_placement:
                t0 = time.perf_counter()
                stats = stats_from_mask_shards(iter_trace_shards(shard_dir, l),
                                               n_neurons=cfg.d_ff,
                                               device=device)
                dist = stats.distance_matrix()     # one copy to the host
                del stats
                counts_s += time.perf_counter() - t0
                placements.append(search_placement(dist, mode=placement_mode))
            else:
                placements.append(identity_placement(cfg.d_ff))
    finally:
        if tmp is not None:
            tmp.cleanup()

    n_mats = 3 if cfg.activation == "silu" else 2
    pack_meta = dict(
        d_model=cfg.d_model, d_ff=cfg.d_ff, n_mats=n_mats,
        activation=cfg.activation, tokens_traced=traced,
        placement="linked" if use_placement else "identity",
    )
    pack_meta.update(meta or {})
    version_kw = {} if pack_version is None else {"version": pack_version}
    t0 = time.perf_counter()
    manifest = write_pack(out_path, bundles, placements,
                          quantize=quantize, meta=pack_meta, **version_kw)
    write_s = time.perf_counter() - t0
    return PackBuildReport(
        path=manifest["path"], n_layers=len(bundles), n_neurons=cfg.d_ff,
        bundle_width=bundles[0].shape[1], quantized=manifest["quantized"],
        file_bytes=manifest["file_bytes"], tokens_traced=traced,
        search_seconds=sum(p.search_seconds for p in placements),
        placement_mode="linked" if use_placement else "identity",
        build_seconds=time.perf_counter() - t_start,
        trace_seconds=trace_s, counts_seconds=counts_s,
        write_seconds=write_s)
