"""Move parameters between the reference package's layout and the port's.

`params_from_numpy` takes the reference's params pytree as nested dicts of
numpy arrays (what `jax.tree_util.tree_map(np.asarray, params)` gives) and
returns the port's params: the same leaf names and the same layouts
(`w_up` [d, d_ff], `w_down` [d_ff, d], a MoE FFN's router [d, E] and
expert weights [E, d, f], the SSM mixers' leaves, ...), with each stacked
scan axis unstacked into a list: the [G, ...] group axis of
`params["stack"]`, and the [L, ...] layer axis of an encoder-decoder's
`encoder["layers"]` and `decoder["layers"]`. `params_to_numpy` is its
inverse (checkpoints use it). bf16 leaves travel as their 16-bit patterns.
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

# numpy has no bf16 of its own: `params_to_numpy` gives a bf16 leaf as an
# array of this 2-byte void dtype holding its bit patterns, which is also
# what `np.load` returns for a bf16 leaf the reference saved
BF16_BITS = np.dtype("V2")


def _to_tensor(a, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16" or a.dtype == BF16_BITS:
        # the reference's bf16 leaves come from an extension dtype named
        # "bfloat16", or as void-2 bits from a file: move the 16-bit
        # patterns as they are
        bits = torch.from_numpy(a.view(np.uint16).copy())
        return bits.view(torch.bfloat16).to(device)
    return torch.tensor(a, device=device)


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor on the host as numpy, bf16 as `BF16_BITS` (the same bits)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(BF16_BITS)
    return t.numpy()


def _tree(tree: Any, fn) -> Any:
    if isinstance(tree, dict):
        return {k: _tree(v, fn) for k, v in tree.items()}
    return fn(tree)


def _unstack(stacked: Any, n: int, dev: torch.device, what: str) -> list:
    """A dict of stacked [n, ...] numpy leaves as a list of n dicts of
    tensors; raises ValueError when a leading axis is not `n`."""
    for leaf in _leaves(stacked):
        if np.shape(leaf)[0] != n:
            raise ValueError(f"stacked leaf with leading axis "
                             f"{np.shape(leaf)[0]}, config has {n} {what}")
    return [_tree(stacked, lambda a, i=i: _to_tensor(np.asarray(a)[i], dev))
            for i in range(n)]


def params_from_numpy(tree: Dict[str, Any], cfg: ModelConfig,
                      device: DeviceLike = None) -> Dict[str, Any]:
    """Reference params (numpy leaves) -> port params on `device` (default
    cuda). Raises ValueError for a stack whose leading axis is not the
    config's group count, or encoder / decoder layers whose leading axis is
    not the config's layer count."""
    dev = resolve_device(device)
    out = {}
    for k, v in tree.items():
        if k == "stack":
            out[k] = _unstack(v, cfg.n_layers // transformer.stack_period(cfg),
                              dev, "groups")
        elif k in ("encoder", "decoder"):
            n = cfg.n_enc_layers if k == "encoder" else cfg.n_layers
            out[k] = {kk: (_unstack(vv, n, dev, f"{k} layers")
                           if kk == "layers"
                           else _tree(vv, lambda a: _to_tensor(a, dev)))
                      for kk, vv in v.items()}
        else:
            out[k] = _tree(v, lambda a: _to_tensor(a, dev))
    return out


def stack_lists(tree: Any, leaf_fn) -> Any:
    """`tree` with every list of like dicts stacked into one dict of
    [n, ...] leaves (`leaf_fn` maps a leaf, then leaves are stacked)."""
    if isinstance(tree, dict):
        return {k: stack_lists(v, leaf_fn) for k, v in tree.items()}
    if isinstance(tree, list):
        if isinstance(tree[0], dict):
            return {k: stack_lists([t[k] for t in tree], leaf_fn)
                    for k in tree[0]}
        leaves = [leaf_fn(t) for t in tree]
        if leaves[0].dtype == BF16_BITS:
            return np.stack([a.view(np.uint16) for a in leaves]).view(
                BF16_BITS)
        return np.stack(leaves)
    return leaf_fn(tree)


def params_to_numpy(params: Dict[str, Any]) -> Dict[str, Any]:
    """Port params -> the reference's layout as numpy: each list of group or
    layer dicts stacked back into [G, ...] / [L, ...] leaves, bf16 leaves
    as `BF16_BITS`. `params_from_numpy` of the result gives back the same
    bits."""
    return stack_lists(params, tensor_to_numpy)


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
