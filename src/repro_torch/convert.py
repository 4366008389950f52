"""Load the reference package's parameters into the port.

`params_from_numpy` takes the reference's params pytree as nested dicts of
numpy arrays (what `jax.tree_util.tree_map(np.asarray, params)` gives) and
returns the port's params: the same leaf names and the same layouts
(`w_up` [d, d_ff], `w_down` [d_ff, d], ...), with the stacked [G, ...] scan
axis of `params["stack"]` unstacked into a list of G group dicts.
`predictor_params_from_numpy` does the same for one activation predictor
(`PredictorParams` w1, b1, w2, b2). Nothing here imports the reference
package; it only reads arrays.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.predictor import PredictorParams
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import transformer


def _to_tensor(a, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        # numpy has no bf16 of its own (the reference's bf16 leaves come
        # from an extension dtype named "bfloat16"): move the 16-bit
        # patterns as they are
        bits = torch.from_numpy(a.view(np.uint16).copy())
        return bits.view(torch.bfloat16).to(device)
    return torch.tensor(a, device=device)


def _tree(tree: Any, fn) -> Any:
    if isinstance(tree, dict):
        return {k: _tree(v, fn) for k, v in tree.items()}
    return fn(tree)


def params_from_numpy(tree: Dict[str, Any], cfg: ModelConfig,
                      device: DeviceLike = None) -> Dict[str, Any]:
    """Reference params (numpy leaves) -> port params on `device` (default
    cuda). Raises ValueError for model families the port does not serve and
    for a stack whose leading axis is not the config's group count."""
    transformer.check_supported(cfg)
    dev = resolve_device(device)
    G = cfg.n_layers // transformer.stack_period(cfg)
    stacked = tree["stack"]
    for leaf in _leaves(stacked):
        if np.shape(leaf)[0] != G:
            raise ValueError(f"stacked leaf with leading axis "
                             f"{np.shape(leaf)[0]}, config has {G} groups")
    out = {k: _tree(v, lambda a: _to_tensor(a, dev))
           for k, v in tree.items() if k != "stack"}
    out["stack"] = [_tree(stacked, lambda a, g=g: _to_tensor(np.asarray(a)[g],
                                                             dev))
                    for g in range(G)]
    return out


def predictor_params_from_numpy(params, device: DeviceLike = None
                                ) -> PredictorParams:
    """One reference predictor's (w1, b1, w2, b2) — its `PredictorParams`
    with numpy (or array) leaves — as the port's `PredictorParams` on
    `device` (default cuda), the same values and layouts."""
    dev = resolve_device(device)
    return PredictorParams(*(_to_tensor(a, dev) for a in params))


def _leaves(tree: Any):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree
