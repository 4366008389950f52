"""Activation-trace capture and synthetic co-activation workloads, in torch.

Three sources of FFN activation masks, as in the reference package:
  * `trace_model_activations` — run the port's model over a token stream
    (`Model.forward(..., capture_activations=True)`) and record per-layer FFN
    activation masks (ReLU > 0 or top-k magnitude).
  * `ShardedTraceWriter` / `iter_trace_shards` — the same capture streamed to
    disk as per-layer `.npy` shards, so the offline packer accumulates
    co-activation statistics over traces larger than RAM
    (`repro_torch.core.coactivation.stats_from_mask_shards`). Shard names
    (``layer{l:03d}_shard{k:05d}.npy``) and ``manifest.json`` are the
    reference's, so each package reads the other's traces.
  * `synthetic_masks` — the planted-cluster generator (paper Figure 6), a
    numpy copy of the reference that gives the same masks bit for bit from
    the same config.
"""
from __future__ import annotations

import dataclasses
import json
import os
import pathlib
from typing import Iterable, Iterator, List, Optional, Union

import numpy as np
import torch


@dataclasses.dataclass
class SyntheticTraceConfig:
    n_neurons: int = 1024
    n_clusters: int = 32
    clusters_per_token: int = 3
    member_p: float = 0.9       # P(neuron fires | its cluster fires)
    noise_p: float = 0.01       # background activation probability
    zipf_alpha: float = 1.1     # cluster popularity skew
    seed: int = 0               # token sampling seed (the "dataset")
    structure_seed: Optional[int] = None   # cluster membership (the "model");
    #                                        defaults to `seed` if None
    popularity_seed: Optional[int] = None  # which clusters are popular
    #                                        (dataset-dependent); default fixed


def synthetic_masks(cfg: SyntheticTraceConfig, n_tokens: int) -> np.ndarray:
    """[n_tokens, n_neurons] bool planted-cluster activation masks.

    Cluster membership is a random partition of neuron ids (seeded by
    structure_seed, a property of the model), so the identity layout
    scatters each cluster across the address space. Token sampling (seed)
    and cluster popularity (popularity_seed) are properties of the dataset.
    """
    s_seed = cfg.structure_seed if cfg.structure_seed is not None else cfg.seed
    struct_rng = np.random.default_rng(s_seed)
    perm = struct_rng.permutation(cfg.n_neurons)
    cluster_of = np.empty(cfg.n_neurons, dtype=np.int64)
    for c in range(cfg.n_clusters):
        members = perm[c::cfg.n_clusters]
        cluster_of[members] = c
    # zipf-ish popularity over clusters; which clusters are hot is dataset-driven
    weights = 1.0 / np.arange(1, cfg.n_clusters + 1) ** cfg.zipf_alpha
    weights /= weights.sum()
    if cfg.popularity_seed is not None:
        pop_rng = np.random.default_rng(cfg.popularity_seed)
        weights = weights[pop_rng.permutation(cfg.n_clusters)]
    rng = np.random.default_rng(cfg.seed)
    masks = np.zeros((n_tokens, cfg.n_neurons), dtype=bool)
    for t in range(n_tokens):
        active_clusters = rng.choice(cfg.n_clusters, size=cfg.clusters_per_token, replace=False, p=weights)
        in_active = np.isin(cluster_of, active_clusters)
        fire = rng.random(cfg.n_neurons)
        masks[t] = (in_active & (fire < cfg.member_p)) | (fire < cfg.noise_p)
    return masks


def relu_activation_mask(pre_act: torch.Tensor) -> torch.Tensor:
    """ReLU-family sparsity: a neuron is activated iff its intermediate > 0."""
    return pre_act > 0


def topk_activation_mask(pre_act: torch.Tensor, k: int) -> torch.Tensor:
    """Magnitude top-k per token — used for non-ReLU (SiLU) models.

    Kept for parity with the reference (src/repro/core/trace.py:80-83): its
    threshold is the NEGATED k-th largest magnitude, so every neuron passes
    and a top-k trace is all ones, in both packages."""
    mag = pre_act.abs()
    # the reference's -top_k(-(-|x|), k)[0][..., -1:] (core/trace.py:82)
    thresh = -torch.topk(mag, k, dim=-1).values[..., -1:]
    return mag >= thresh


class ShardedTraceWriter:
    """Streaming activation-trace store: per-layer boolean mask shards.

    Each `append(layer, masks)` writes one `.npy` shard
    (``layer{l:03d}_shard{k:05d}.npy``, bool [T_k, n]); nothing but the
    current batch's masks is held in memory. `finish()` writes a
    ``manifest.json`` recording the shard lists and token counts; readers go
    through `iter_trace_shards`, which prefers the manifest and falls back to
    a directory glob for unfinished traces. `append` takes a numpy array or
    a tensor on any device (a tensor is copied to the host to be written).
    """

    MANIFEST = "manifest.json"

    def __init__(self, root: Union[str, os.PathLike], n_layers: int,
                 n_neurons: int) -> None:
        self.root = pathlib.Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.n_layers = n_layers
        self.n_neurons = n_neurons
        self._shards: List[List[str]] = [[] for _ in range(n_layers)]
        self._tokens = [0] * n_layers

    def append(self, layer: int, masks) -> pathlib.Path:
        if isinstance(masks, torch.Tensor):
            masks = masks.cpu().numpy()
        masks = np.atleast_2d(np.asarray(masks, dtype=bool))
        if masks.shape[-1] != self.n_neurons:
            raise ValueError(f"mask width {masks.shape[-1]} != n_neurons "
                             f"{self.n_neurons}")
        k = len(self._shards[layer])
        path = self.root / f"layer{layer:03d}_shard{k:05d}.npy"
        np.save(path, masks)
        self._shards[layer].append(path.name)
        self._tokens[layer] += masks.shape[0]
        return path

    def finish(self) -> dict:
        manifest = dict(n_layers=self.n_layers, n_neurons=self.n_neurons,
                        tokens_per_layer=self._tokens, shards=self._shards)
        (self.root / self.MANIFEST).write_text(json.dumps(manifest, indent=1))
        return manifest


def iter_trace_shards(root: Union[str, os.PathLike],
                      layer: int) -> Iterator[np.ndarray]:
    """Yield one layer's mask shards in write order, one array at a time."""
    root = pathlib.Path(root)
    manifest = root / ShardedTraceWriter.MANIFEST
    if manifest.exists():
        names = json.loads(manifest.read_text())["shards"][layer]
    else:
        names = sorted(p.name for p in root.glob(f"layer{layer:03d}_shard*.npy"))
    for name in names:
        yield np.load(root / name)


def batch_masks(model, params, tokens,
                sparsity_topk: Optional[int] = None) -> torch.Tensor:
    """One forward of `model` over a [B, T] token batch; the per-dense-layer
    activation masks, bool [L, B*T, N], on the model's device."""
    tokens = torch.as_tensor(np.asarray(tokens), dtype=torch.int64,
                             device=model.device)
    with torch.inference_mode():
        pre = model.forward(params, {"tokens": tokens},
                            capture_activations=True)["ffn_pre_act"]
    masks = (relu_activation_mask(pre) if sparsity_topk is None
             else topk_activation_mask(pre, sparsity_topk))
    return masks.reshape(masks.shape[0], -1, masks.shape[-1])


def trace_model_activations(
    model,
    params,
    token_batches: Iterable[np.ndarray],
    sparsity_topk: Optional[int] = None,
) -> List[np.ndarray]:
    """Run `model.forward(params, {"tokens": ...}, capture_activations=True)`
    over the batches. Returns per-layer [total_tokens, N] bool masks (host
    numpy), the reference's output for the same pre-activations."""
    per_layer: List[List[np.ndarray]] = []
    for tokens in token_batches:
        masks = batch_masks(model, params, tokens, sparsity_topk).cpu().numpy()
        if not per_layer:
            per_layer = [[] for _ in range(masks.shape[0])]
        for l in range(masks.shape[0]):
            per_layer[l].append(masks[l])
    return [np.concatenate(chunks, axis=0) for chunks in per_layer]
