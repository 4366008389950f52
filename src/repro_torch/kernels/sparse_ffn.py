"""Fused segment-gather sparse FFN: the Hopper kernel's wrapper and its
plain PyTorch version.

    y = sum_s act(x @ (W_up[seg_s] * sv_s)^T) [* (x @ (W_gate[seg_s] * sv_s)^T)]
              @ (W_down[seg_s] * sv_s)

The activated neuron set arrives as segment ids (each segment = `seg`
consecutive neurons of the placement-permuted physical layout) plus a
per-neuron multiplier tile `scale_tiles[s, j]` = dequant scale (1.0 for
float payloads) x membership in the served union. Weight rows may be int8
(the NeuronPack storage dtype) or float32; they are dequantized and masked
on the device, right before the products. Segment ids of -1 are padding and
contribute exactly 0.

`sparse_ffn_segments_fused_cuda` launches the hand-written kernel in
`csrc/sparse_ffn_fused.cu` (see the note there for its bound and design);
`sparse_ffn_segments_fused_plain` is the same math in the same order as the
reference's XLA twin (`ops._sparse_ffn_segments_fused_xla`): gather the raw
[seg, D] tiles, upcast, multiply by the scale column, then the products.
`repro_torch.kernels.ops.sparse_ffn_segments_fused` dispatches between them
by the device of the input.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels.build import Counts, load_library
from repro_torch.models.layers import apply_activation

ACTIVATIONS = {"relu": 0, "relu2": 1, "gelu": 2, "silu": 3}
WEIGHT_DTYPES = (torch.float32, torch.int8)


counts = Counts()   # this kernel's own launch / plain-call counters


def sparse_ffn_segments_fused_plain(
    x: torch.Tensor,              # [B, D] float
    w_up: torch.Tensor,           # [N, D] raw storage dtype (int8 or float)
    w_down: torch.Tensor,         # [N, D]
    seg_ids: torch.Tensor,        # [S] int32 (-1 = padding)
    scale_tiles: torch.Tensor,    # [S, seg] f32 dequant-scale x mask
    w_gate: Optional[torch.Tensor] = None,
    *,
    seg_size: int = 128,
    activation: str = "relu",
) -> torch.Tensor:
    """Plain PyTorch version of the fused kernel (f32 [B, D] out)."""
    S = seg_ids.shape[0]
    D = x.shape[1]
    tiles = torch.where(seg_ids < 0, 0, seg_ids).long()
    sv = torch.where((seg_ids < 0)[:, None], 0.0,
                     scale_tiles.float()).reshape(S * seg_size, 1)

    def eff(w):
        t = w.reshape(-1, seg_size, D)[tiles].reshape(S * seg_size, D)
        return t.float() * sv

    xf = x.float()
    act = apply_activation(xf @ eff(w_up).T, activation)
    if w_gate is not None:
        act = act * (xf @ eff(w_gate).T)
    return act @ eff(w_down)


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"sparse_ffn_segments_fused: {msg}")


def _bind(lib: ctypes.CDLL):
    fn = lib.sparse_ffn_segments_fused_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def sparse_ffn_segments_fused_cuda(
    x: torch.Tensor,
    w_up: torch.Tensor,
    w_down: torch.Tensor,
    seg_ids: torch.Tensor,
    scale_tiles: torch.Tensor,
    w_gate: Optional[torch.Tensor] = None,
    *,
    seg_size: int = 128,
    activation: str = "relu",
) -> torch.Tensor:
    """Launch the Hopper kernel on PyTorch's current stream. Validates
    device, dtype, shape, contiguity and alignment and raises ValueError on
    what the kernel does not take; raises RuntimeError if a launch fails.
    Outputs and scratch are allocated here; nothing synchronises."""
    dev = x.device
    tensors = {"x": x, "w_up": w_up, "w_down": w_down, "seg_ids": seg_ids,
               "scale_tiles": scale_tiles}
    if w_gate is not None:
        tensors["w_gate"] = w_gate
    for name, t in tensors.items():
        _check(t.device == dev and dev.type == "cuda",
               f"{name} is on {t.device}, expected the CUDA device {dev}")
        _check(t.is_contiguous(), f"{name} must be contiguous")
        _check(t.data_ptr() % 16 == 0, f"{name} must be 16-byte aligned")
    _check(activation in ACTIVATIONS, f"unknown activation {activation!r}")
    _check(x.dtype == torch.float32 and x.ndim == 2, "x must be f32 [B, D]")
    B, D = x.shape
    _check(w_up.dtype in WEIGHT_DTYPES,
           f"weights must be float32 or int8, got {w_up.dtype}")
    for name in ("w_down", "w_gate"):
        if name in tensors:
            _check(tensors[name].dtype == w_up.dtype and
                   tensors[name].shape == w_up.shape,
                   f"{name} must match w_up's dtype and shape")
    _check(w_up.ndim == 2 and w_up.shape[1] == D, "weights must be [N, D]")
    N = w_up.shape[0]
    _check(N % seg_size == 0, f"N={N} is not a multiple of seg={seg_size}")
    _check(D % 4 == 0, f"D={D} must be a multiple of 4 (16-byte row loads)")
    _check(seg_ids.dtype == torch.int32 and seg_ids.ndim == 1,
           "seg_ids must be int32 [S]")
    S = seg_ids.shape[0]
    _check(scale_tiles.dtype == torch.float32 and
           tuple(scale_tiles.shape) == (S, seg_size),
           f"scale_tiles must be f32 [S={S}, seg={seg_size}]")
    out = torch.empty((B, D), dtype=torch.float32, device=dev)
    if S == 0 or B == 0:
        return out.zero_()
    act = torch.empty((S, B, seg_size), dtype=torch.float32, device=dev)
    partial = torch.empty((S, B, D), dtype=torch.float32, device=dev)
    launch = _bind(load_library("sparse_ffn_fused"))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = launch(x.data_ptr(), w_up.data_ptr(),
                     None if w_gate is None else w_gate.data_ptr(),
                     w_down.data_ptr(), seg_ids.data_ptr(),
                     scale_tiles.data_ptr(), act.data_ptr(),
                     partial.data_ptr(), out.data_ptr(), B, D, N, S, seg_size,
                     int(w_up.dtype == torch.int8), ACTIVATIONS[activation],
                     stream)
    if err != 0:
        raise RuntimeError(f"sparse_ffn_segments_fused kernel launch failed "
                           f"with CUDA error {err}")
    counts.launches += 1
    return out
