"""Sparse FFN math over flash bundles, in torch.

A "neuron" n of an FFN block is the bundle {W_gate[n, :], W_up[n, :],
W_down[:, n]} (2-matrix models drop the gate). With ReLU, the FFN output is
exactly preserved when computing only over neurons whose intermediate is
> 0. `sparse_ffn_from_bundles` is what the offload runtime's "bundles" path
evaluates (the identity layout); linked layouts go through the fused segment
kernel in `repro_torch.kernels`.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.models.layers import apply_activation


class FFNWeights(NamedTuple):
    w_up: torch.Tensor             # [n_neurons, d_model]
    w_down: torch.Tensor           # [n_neurons, d_model]
    w_gate: Optional[torch.Tensor] = None   # [n_neurons, d_model] or None


def dense_ffn(x: torch.Tensor, w: FFNWeights,
              activation: str = "relu") -> torch.Tensor:
    """x: [..., d_model] -> [..., d_model]."""
    act = apply_activation(x @ w.w_up.T, activation)
    if w.w_gate is not None:
        act = act * (x @ w.w_gate.T)
    return act @ w.w_down


def ffn_pre_activation(x: torch.Tensor, w: FFNWeights) -> torch.Tensor:
    return x @ w.w_up.T


def sparse_ffn_gather(
    x: torch.Tensor,
    w: FFNWeights,
    neuron_ids: torch.Tensor,
    activation: str = "relu",
    valid_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """FFN over an activated subset (padded with `valid_mask`).

    x: [B, d]; neuron_ids: [k] integer ids (may contain padding);
    valid_mask: [k] bool. Exact when the true activated set is a subset of
    neuron_ids (ReLU zeroes the rest anyway); padding rows are masked to
    zero contribution.
    """
    up = w.w_up[neuron_ids]                      # [k, d]
    act = apply_activation(x @ up.T, activation)
    if w.w_gate is not None:
        act = act * (x @ w.w_gate[neuron_ids].T)
    if valid_mask is not None:
        act = act * valid_mask[None, :].to(act.dtype)
    return act @ w.w_down[neuron_ids]            # [B, d]


def sparse_ffn_from_bundles(
    x: torch.Tensor,
    bundles: torch.Tensor,
    d_model: int,
    n_mats: int,
    activation: str = "relu",
    valid_mask: Optional[torch.Tensor] = None,
    scales: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """FFN computed directly from flash bundle payloads (engine read path).

    bundles: [k, n_mats * d_model] rows as stored in flash — layout per
    neuron: [up | down] (n_mats=2) or [gate | up | down] (n_mats=3).
    scales: optional [k] f32 per-neuron symmetric dequant scales; when given,
    bundles may be raw int8 rows and are dequantized on the device
    (q.float() * scale).
    """
    k = bundles.shape[0]
    if scales is not None:
        bundles = bundles.float() * scales[:, None]
    parts = bundles.reshape(k, n_mats, d_model)
    if n_mats == 3:
        w = FFNWeights(w_up=parts[:, 1], w_down=parts[:, 2], w_gate=parts[:, 0])
    else:
        w = FFNWeights(w_up=parts[:, 0], w_down=parts[:, 1], w_gate=None)
    act = apply_activation(x @ w.w_up.T, activation)
    if w.w_gate is not None:
        act = act * (x @ w.w_gate.T)
    if valid_mask is not None:
        act = act * valid_mask[None, :].to(act.dtype)
    return act @ w.w_down


def make_bundles(w: FFNWeights) -> np.ndarray:
    """Pack FFN weights into per-neuron flash bundles [n, n_mats*d] (host
    numpy: bundles are what the simulated flash store holds). numpy has no
    bf16, so bf16 weights give their 16-bit patterns as uint16: 2 bytes an
    element, as the reference's bf16 bundles (`bundle_tensor` reads them
    back)."""
    cols = ([w.w_gate, w.w_up, w.w_down] if w.w_gate is not None
            else [w.w_up, w.w_down])
    b = torch.cat(cols, dim=-1).cpu()
    if b.dtype == torch.bfloat16:
        return b.view(torch.int16).numpy().view(np.uint16)
    return b.numpy()


def bundle_tensor(a: np.ndarray) -> torch.Tensor:
    """A host bundle payload as a tensor sharing its memory: uint16 rows
    are bf16 bit patterns (`make_bundles`) and come back as bfloat16,
    unrounded."""
    if a.dtype == np.uint16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)
