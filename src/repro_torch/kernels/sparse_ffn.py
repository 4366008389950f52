"""Segment-gather sparse FFNs: two Hopper kernels' wrappers and their plain
PyTorch versions — the fused one of the offload path (int8 or float rows,
dequant scales and the activated-union mask applied on the device) and the
unfused float one of `serve_sparse` decode (no scales).

Fused:

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

Unfused (the reference's `sparse_ffn_segments_kernel`):

    y = sum_s act(x @ W_up[seg_s]^T) [* (x @ W_gate[seg_s]^T)] @ W_down[seg_s]

with float32 or bfloat16 [N, D] weight operands of any element strides (the
model passes `w_up.T` views of its [d, d_ff] weights), a negative segment id
as the zero padding segment and a repeated id counted twice, in float32.
`sparse_ffn_segments_cuda` launches `csrc/sparse_ffn_segments.cu`;
`sparse_ffn_segments_plain` gathers the segments' rows and does the
products; `ops.sparse_ffn_segments` dispatches, with its own counters
(`segments_counts`).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels.build import Counts, load_library
from repro_torch.models.layers import apply_activation

ACTIVATIONS = {"relu": 0, "relu2": 1, "gelu": 2, "silu": 3}
WEIGHT_DTYPES = (torch.float32, torch.int8)


SEGMENT_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

counts = Counts()            # the fused kernel's launch / plain-call counters
segments_counts = Counts()   # the unfused kernel's


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


# -- unfused float segment FFN (serve_sparse decode) ---------------------------

def sparse_ffn_segments_plain(
    x: torch.Tensor,              # [B, D] float
    w_up: torch.Tensor,           # [N, D] float (any strides)
    w_down: torch.Tensor,         # [N, D]
    seg_ids: torch.Tensor,        # [S] int (negative = padding)
    w_gate: Optional[torch.Tensor] = None,
    *,
    seg_size: int = 128,
    activation: str = "relu",
) -> torch.Tensor:
    """Plain PyTorch version of the unfused kernel (f32 [B, D] out)."""
    S = seg_ids.shape[0]
    D = x.shape[1]
    ids = seg_ids.long()
    live = (ids >= 0).float()[:, None, None]

    def gathered(w):
        t = w.reshape(-1, seg_size, D)[ids.clamp_min(0)].float() * live
        return t.reshape(S * seg_size, D)

    xf = x.float()
    act = apply_activation(xf @ gathered(w_up).T, activation)
    if w_gate is not None:
        act = act * (xf @ gathered(w_gate).T)
    return act @ gathered(w_down)


def _check_segments(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"sparse_ffn_segments: {msg}")


def _bind_segments(lib: ctypes.CDLL):
    fn = lib.sparse_ffn_segments_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 5
                       + [ctypes.c_longlong] * 6 + [ctypes.c_int] * 2
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def sparse_ffn_segments_cuda(
    x: torch.Tensor,
    w_up: torch.Tensor,
    w_down: torch.Tensor,
    seg_ids: torch.Tensor,
    w_gate: Optional[torch.Tensor] = None,
    *,
    seg_size: int = 128,
    activation: str = "relu",
) -> torch.Tensor:
    """Launch the Hopper kernel on PyTorch's current stream. Validates
    device, dtype and shape and raises ValueError on what the kernel does
    not take; raises RuntimeError if a launch fails. Weights are read in
    place through their strides; x is taken as float32 (a bf16 x is
    converted, a [B, D] copy). Outputs and scratch are allocated here;
    nothing synchronises. A segment id >= N / seg_size traps on the device."""
    dev = x.device
    tensors = {"x": x, "w_up": w_up, "w_down": w_down, "seg_ids": seg_ids}
    if w_gate is not None:
        tensors["w_gate"] = w_gate
    for name, t in tensors.items():
        _check_segments(t.device == dev and dev.type == "cuda",
                        f"{name} is on {t.device}, expected the CUDA device "
                        f"{dev}")
    _check_segments(activation in ACTIVATIONS,
                    f"unknown activation {activation!r}")
    _check_segments(x.ndim == 2 and x.dtype in SEGMENT_DTYPES,
                    "x must be float32 or bfloat16 [B, D]")
    B, D = x.shape
    _check_segments(w_up.dtype in SEGMENT_DTYPES,
                    f"weights must be float32 or bfloat16, got {w_up.dtype}")
    _check_segments(w_up.ndim == 2 and w_up.shape[1] == D,
                    f"weights must be [N, D={D}]")
    for name in ("w_down", "w_gate"):
        if name in tensors:
            _check_segments(tensors[name].dtype == w_up.dtype and
                            tensors[name].shape == w_up.shape,
                            f"{name} must match w_up's dtype and shape")
    N = w_up.shape[0]
    _check_segments(seg_size % 32 == 0 and seg_size > 0,
                    f"seg_size={seg_size} must be a positive multiple of 32")
    _check_segments(N % seg_size == 0,
                    f"N={N} is not a multiple of seg={seg_size}")
    _check_segments(seg_ids.dtype == torch.int32 and seg_ids.ndim == 1
                    and seg_ids.is_contiguous(),
                    "seg_ids must be contiguous int32 [S]")
    S = seg_ids.shape[0]
    out = torch.empty((B, D), dtype=torch.float32, device=dev)
    if S == 0 or B == 0 or D == 0:
        return out.zero_()
    xf = x.float().contiguous()
    SK = S * seg_size
    n_dc = -(-D // 256)
    part = torch.empty((1 + (w_gate is not None), n_dc, B, SK),
                       dtype=torch.float32, device=dev)
    act = torch.empty((B, SK), dtype=torch.float32, device=dev)
    pout = torch.empty((S, B, D), dtype=torch.float32, device=dev)
    gate_strides = (0, 0) if w_gate is None else w_gate.stride()
    launch = _bind_segments(load_library("sparse_ffn_segments"))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = launch(xf.data_ptr(), w_up.data_ptr(),
                     None if w_gate is None else w_gate.data_ptr(),
                     w_down.data_ptr(), seg_ids.data_ptr(), part.data_ptr(),
                     act.data_ptr(), pout.data_ptr(), out.data_ptr(),
                     B, D, N, S, seg_size, *w_up.stride(), *gate_strides,
                     *w_down.stride(), SEGMENT_DTYPES[w_up.dtype],
                     ACTIVATIONS[activation], stream)
    if err != 0:
        raise RuntimeError(f"sparse_ffn_segments kernel launch failed with "
                           f"CUDA error {err}")
    segments_counts.launches += 1
    return out
