"""Co-activation counts A = MᵀM: the Hopper kernel's wrapper and its plain
PyTorch version.

M is a [T, N] activation mask (bool, or uint8 0/1 as the trace gives it);
A[i, j] counts the tokens in which neurons i and j both fire, a float32
[N, N] matrix (the diagonal holds each neuron's own count). The counts are
small integers, so every route computes them exactly and gives the same
float32 bits as numpy's `m.T @ m`, as long as each entry stays below 2^24
(T < 2^24 for 0/1 masks); a running float32 sum of several blocks, as
`CoActivationStats` keeps, has the same limit per entry, as the reference's
float32 buffer does.

`coact_accumulate_cuda` launches the hand-written kernel in `csrc/coact.cu`
(see the note there for its bound and design); `coact_accumulate_plain` is
`m.float().T @ m.float()`. `repro_torch.kernels.ops.coact_accumulate`
dispatches between them by the device of the input.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import Counts, load_library

MASK_DTYPES = (torch.bool, torch.uint8)
MAX_TOKENS = 1 << 24        # counts above 2^24 are not exact in float32
TILE_N, TILE_T = 128, 64    # the kernel's padding of neurons and tokens

counts = Counts()   # this kernel's own launch / plain-call counters


def coact_accumulate_plain(masks: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: f32 [N, N] = masks.float().T @ masks.float()."""
    _check(masks.ndim == 2, f"masks must be [T, N], got shape "
                            f"{tuple(masks.shape)}")
    m = masks.to(torch.float32)
    return m.T @ m


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"coact_accumulate: {msg}")


def _bind(lib: ctypes.CDLL):
    fn = lib.coact_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def coact_accumulate_cuda(masks: torch.Tensor) -> torch.Tensor:
    """Launch the Hopper kernel on PyTorch's current stream; returns a fresh
    f32 [N, N]. Takes a bool or uint8 [T, N] mask on a CUDA device (a
    transposed or sliced view is made contiguous here; bool is read as its
    0/1 bytes). Raises ValueError on what the kernel does not take and
    RuntimeError if a launch fails. The transposed, padded scratch copy
    (N rounded up to 128, T to 64, one byte each) and the output are
    allocated here; nothing synchronises."""
    _check(masks.ndim == 2, f"masks must be [T, N], got shape "
                            f"{tuple(masks.shape)}")
    _check(masks.dtype in MASK_DTYPES,
           f"masks must be bool or uint8, got {masks.dtype}")
    T, N = masks.shape
    _check(T < MAX_TOKENS, f"T = {T} tokens: counts past 2^24 are not exact "
                           f"in float32; accumulate in blocks")
    _check(masks.device.type == "cuda",
           f"masks are on {masks.device}, expected a CUDA device")
    dev = masks.device
    if T == 0 or N == 0:
        return torch.zeros((N, N), dtype=torch.float32, device=dev)
    m = masks.contiguous()
    if m.dtype == torch.bool:
        m = m.view(torch.uint8)
    Np = -(-N // TILE_N) * TILE_N
    Tp = -(-T // TILE_T) * TILE_T
    scratch = torch.empty((Np, Tp), dtype=torch.uint8, device=dev)
    out = torch.empty((N, N), dtype=torch.float32, device=dev)
    launch = _bind(load_library("coact"))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = launch(m.data_ptr(), scratch.data_ptr(), out.data_ptr(),
                     T, N, Tp, Np, stream)
    if err != 0:
        raise RuntimeError(f"coact_accumulate kernel launch failed with "
                           f"CUDA error {err}")
    counts.launches += 1
    return out
