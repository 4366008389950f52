"""Kernel dispatchers: one public entry per kernel, routed by the input's
device.

A CPU tensor goes to the kernel's plain PyTorch version; a CUDA tensor
launches the hand-written Hopper kernel, or raises (a build or launch
failure is an error, never a quiet fall-back to the plain version).
`counts` shows which route a run took: `counts.launches` counts kernel
launches, `counts.plain_calls` plain-version calls.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.sparse_ffn import (counts,
                                            sparse_ffn_segments_fused_cuda,
                                            sparse_ffn_segments_fused_plain)

__all__ = ["counts", "sparse_ffn_segments_fused"]


def sparse_ffn_segments_fused(
    x: torch.Tensor,              # [B, D]
    w_up: torch.Tensor,           # [N, D] raw storage dtype (int8 stays int8)
    w_down: torch.Tensor,         # [N, D]
    seg_ids: torch.Tensor,        # [S] int32 segment block-indices (pad -1)
    scale_tiles: torch.Tensor,    # [S, seg] f32 dequant-scale x activated-mask
    w_gate: Optional[torch.Tensor] = None,
    *,
    seg_size: int = 128,
    activation: str = "relu",
) -> torch.Tensor:
    """Fused dequant + mask + segment-gather FFN; f32 [B, D].

    `scale_tiles[s, j]` multiplies the weight rows of physical neuron
    `seg_ids[s] * seg_size + j` before both products: the int8 dequant scale
    (1.0 for float payloads) for neurons in the activated union, 0.0 for
    covered-but-not-activated neurons — exact for relu/relu2/gelu/silu since
    act(0) == 0. Entries of -1 in `seg_ids` are padding and contribute 0."""
    if x.device.type == "cpu":
        counts.plain_calls += 1
        return sparse_ffn_segments_fused_plain(
            x, w_up, w_down, seg_ids, scale_tiles, w_gate,
            seg_size=seg_size, activation=activation)
    if x.device.type == "cuda":
        return sparse_ffn_segments_fused_cuda(
            x, w_up, w_down, seg_ids, scale_tiles, w_gate,
            seg_size=seg_size, activation=activation)
    raise ValueError(f"sparse_ffn_segments_fused: unsupported device "
                     f"{x.device}")
