"""Command lines of the port: `pack` (the offline stage into a NeuronPack)
and `serve` (the InferenceServer front end).

Weights come from the port's seeded init, drawn on the CPU from
`torch.Generator().manual_seed(seed)` and then moved to the run's device,
so a pack built on the card and served on the CPU (or the other way) sees
the same weights. They are not the reference package's `jax.random`
weights: a pack built by one package's CLI is served with other weights by
the other's (geometry validation still applies).
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.device import DeviceLike, resolve_device


def _to(tree: Any, device: torch.device) -> Any:
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


def seeded_model(cfg, seed: int, device: DeviceLike = None):
    """(model on `device`, params drawn on the CPU from `seed`, on `device`)."""
    from repro_torch.models import build_model
    dev = resolve_device(device)
    params = build_model(cfg, device="cpu").init_params(
        torch.Generator().manual_seed(seed))
    return build_model(cfg, device=dev), _to(params, dev)
