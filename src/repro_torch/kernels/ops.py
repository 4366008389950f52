"""Kernel dispatchers: one public entry per kernel, routed by the input's
device.

A CPU tensor goes to the kernel's plain PyTorch version; a CUDA tensor
launches the hand-written Hopper kernel, or raises (a build or launch
failure is an error, never a quiet fall-back to the plain version).
`counts[name]` shows which route a run took for kernel `name`: its
`launches` count kernel launches, its `plain_calls` plain-version calls.
Each kernel keeps its own pair; `reset_counts()` zeroes them all.
"""
from __future__ import annotations

from typing import Dict, Optional, Union

import torch

from repro_torch.kernels import coact, paged_decode, sparse_ffn, swa_decode
from repro_torch.kernels.build import Counts

__all__ = ["counts", "reset_counts", "sparse_ffn_segments_fused",
           "paged_decode_attention", "coact_accumulate",
           "swa_decode_attention", "sparse_ffn_segments"]

counts: Dict[str, Counts] = {
    "sparse_ffn_segments_fused": sparse_ffn.counts,
    "paged_decode": paged_decode.counts,
    "coact_accumulate": coact.counts,
    "swa_decode": swa_decode.counts,
    "sparse_ffn_segments": sparse_ffn.segments_counts,
}


def reset_counts() -> None:
    for c in counts.values():
        c.reset()


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
    act(0) == 0. Entries of -1 in `seg_ids` are padding and contribute 0.
    Rows are float32, bfloat16 or int8; x is taken as float32, as the
    reference's op casts it (`src/repro/kernels/ops.py:104`)."""
    if x.device.type == "cpu":
        sparse_ffn.counts.plain_calls += 1
        return sparse_ffn.sparse_ffn_segments_fused_plain(
            x, w_up, w_down, seg_ids, scale_tiles, w_gate,
            seg_size=seg_size, activation=activation)
    if x.device.type == "cuda":
        return sparse_ffn.sparse_ffn_segments_fused_cuda(
            x.float(), w_up, w_down, seg_ids, scale_tiles, w_gate,
            seg_size=seg_size, activation=activation)
    raise ValueError(f"sparse_ffn_segments_fused: unsupported device "
                     f"{x.device}")


def paged_decode_attention(
    q: torch.Tensor,              # [B, H, hd] query of ONE new token
    k_pages: torch.Tensor,        # [num_pages + 1, page_size, KV, hd] arena
    v_pages: torch.Tensor,        #   (the trailing page is the null page)
    page_tables: torch.Tensor,    # [B, max_pages] int32
    cur_pos: torch.Tensor,        # [B] int32 current (query) position per row
    k_scale: Optional[torch.Tensor] = None,   # [num_pages + 1, page_size, KV]
    v_scale: Optional[torch.Tensor] = None,   #   bf16 (int8 arenas only)
) -> torch.Tensor:
    """Paged-attention decode over a page arena; f32 [B, H, hd]. Raises
    ValueError when only one of the two scales is given."""
    if q.device.type == "cpu":
        paged_decode.counts.plain_calls += 1
        return paged_decode.paged_decode_attention_plain(
            q, k_pages, v_pages, page_tables, cur_pos, k_scale, v_scale)
    if q.device.type == "cuda":
        return paged_decode.paged_decode_attention_cuda(
            q, k_pages, v_pages, page_tables, cur_pos, k_scale, v_scale)
    raise ValueError(f"paged_decode_attention: unsupported device {q.device}")


def coact_accumulate(masks: torch.Tensor,          # [T, N]
                     accumulate_into: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """Co-activation counts MᵀM of a [T, N] mask block, a fresh f32 [N, N],
    exact (each entry below 2^24); with `accumulate_into` (a contiguous f32
    [N, N] on the masks' device) they are added into it in place (`A +=
    MᵀM`) and it is returned. On CUDA the mask must be bool or uint8; the
    plain version on the CPU also takes 0/1 floats."""
    if masks.device.type == "cpu":
        coact.counts.plain_calls += 1
        return coact.coact_accumulate_plain(masks, accumulate_into)
    if masks.device.type == "cuda":
        return coact.coact_accumulate_cuda(masks, accumulate_into)
    raise ValueError(f"coact_accumulate: unsupported device {masks.device}")


def swa_decode_attention(
    q: torch.Tensor,              # [B, H, hd] query of ONE new token
    k_cache: torch.Tensor,        # [B, W, KV, hd] ring
    v_cache: torch.Tensor,
    pos: torch.Tensor,            # [B, W] int32 slot positions (-1 empty)
    cur_pos: Union[int, torch.Tensor],   # scalar, or [B] per row
    *,
    window: int,
) -> torch.Tensor:
    """Sliding-window decode attention over a ring; [B, H, hd] in q's
    dtype. Slot w of row b takes part iff pos >= 0 and
    cur - window < pos <= cur; a row with none gives 0. A scalar `cur_pos`
    is the reference op's signature; a [B] vector (one position per row, for
    the continuous-batching server) is the port's extension of it."""
    if q.device.type == "cpu":
        swa_decode.counts.plain_calls += 1
        return swa_decode.swa_decode_attention_plain(
            q, k_cache, v_cache, pos, cur_pos, window=window)
    if q.device.type == "cuda":
        return swa_decode.swa_decode_attention_cuda(
            q, k_cache, v_cache, pos, cur_pos, window=window)
    raise ValueError(f"swa_decode_attention: unsupported device {q.device}")


def sparse_ffn_segments(
    x: torch.Tensor,              # [B, D]
    w_up: torch.Tensor,           # [N, D] float32 / bfloat16, any strides
    w_down: torch.Tensor,         # [N, D]
    seg_ids: torch.Tensor,        # [S] int32 segment block-indices (pad -1)
    w_gate: Optional[torch.Tensor] = None,
    *,
    seg_size: int = 128,
    activation: str = "relu",
) -> torch.Tensor:
    """Segment-gather FFN over float weights; f32 [B, D]. Entries of -1 in
    `seg_ids` are padding (contribute 0); a repeated id counts twice."""
    if x.device.type == "cpu":
        sparse_ffn.segments_counts.plain_calls += 1
        return sparse_ffn.sparse_ffn_segments_plain(
            x, w_up, w_down, seg_ids, w_gate, seg_size=seg_size,
            activation=activation)
    if x.device.type == "cuda":
        return sparse_ffn.sparse_ffn_segments_cuda(
            x, w_up, w_down, seg_ids, w_gate, seg_size=seg_size,
            activation=activation)
    raise ValueError(f"sparse_ffn_segments: unsupported device {x.device}")
