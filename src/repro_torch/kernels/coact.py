"""Co-activation counts A = MᵀM: the Hopper kernel's wrapper and its plain
PyTorch version.

M is a [T, N] activation mask (bool, or uint8 0/1 as the trace gives it);
A[i, j] counts the tokens in which neurons i and j both fire, a float32
[N, N] matrix (the diagonal holds each neuron's own count). The counts are
small integers, so every route computes them exactly and gives the same
float32 bits as numpy's `m.T @ m`, as long as each entry stays below 2^24
(T < 2^24 for 0/1 masks); a running float32 sum of several blocks, as
`CoActivationStats` keeps, has the same limit per entry, as the reference's
float32 buffer does. With `accumulate_into=A` both routes add the block's
counts into A in place (`A += MᵀM`, the reference's update) and return A.

uint8 masks with byte values above 1 are counted as values. The kernel sums
their products in int32, which holds T·v² for the largest byte v only while
that stays at most 2^31 − 1: from T = 33,026 tokens (`BYTE_VALUE_TOKENS`)
bytes of 255 could overflow, so there the wrapper reads the masks' maximum
and raises ValueError when `int32_sums_fit(T, max)` is false (below that T
nothing is read and nothing synchronises). The plain version's float32
products have no such limit, but past 2^24 an entry is rounded in both.

`coact_accumulate_cuda` launches the hand-written kernel in `csrc/coact.cu`
(see the note there for its bound and design); `coact_accumulate_plain` is
`m.float().T @ m.float()`. `repro_torch.kernels.ops.coact_accumulate`
dispatches between them by the device of the input.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels.build import Counts, load_library

MASK_DTYPES = (torch.bool, torch.uint8)
MAX_TOKENS = 1 << 24        # counts above 2^24 are not exact in float32
INT32_MAX = (1 << 31) - 1   # the kernel's sums are int32
BYTE_VALUE_TOKENS = INT32_MAX // (255 * 255) + 1   # 33,026: bytes of 255
TILE_N, TILE_T = 128, 128   # the kernel's padding of neurons and tokens

counts = Counts()   # this kernel's own launch / plain-call counters


def int32_sums_fit(T: int, vmax: int) -> bool:
    """Whether T products of bytes at most `vmax` always sum within int32:
    T·vmax² <= 2^31 − 1 (for 0/1 masks, T <= 2^31 − 1)."""
    return T * vmax * vmax <= INT32_MAX


def coact_accumulate_plain(masks: torch.Tensor,
                           accumulate_into: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Plain PyTorch version: f32 [N, N] = masks.float().T @ masks.float(),
    or `accumulate_into.add_(...)` of it, returning `accumulate_into`."""
    _check(masks.ndim == 2, f"masks must be [T, N], got shape "
                            f"{tuple(masks.shape)}")
    if accumulate_into is not None:
        _check_into(accumulate_into, masks)
    m = masks.to(torch.float32)
    prod = m.T @ m
    return prod if accumulate_into is None else accumulate_into.add_(prod)


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"coact_accumulate: {msg}")


def _check_into(into: torch.Tensor, masks: torch.Tensor) -> None:
    N = masks.shape[1]
    _check(into.dtype == torch.float32 and tuple(into.shape) == (N, N),
           f"accumulate_into must be float32 [{N}, {N}], got {into.dtype} "
           f"{tuple(into.shape)}")
    _check(into.device == masks.device,
           f"accumulate_into is on {into.device}, the masks on "
           f"{masks.device}")
    _check(into.is_contiguous(), "accumulate_into must be contiguous")


def _bind(lib: ctypes.CDLL):
    fn = lib.coact_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def coact_accumulate_cuda(masks: torch.Tensor,
                          accumulate_into: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Launch the Hopper kernel on PyTorch's current stream; returns a fresh
    f32 [N, N], or adds the counts into `accumulate_into` (a contiguous f32
    [N, N] on the masks' device) in place and returns it. Takes a bool or
    uint8 [T, N] mask on a CUDA device (a transposed or sliced view is made
    contiguous here; bool is read as its 0/1 bytes). Raises ValueError on
    what the kernel does not take (also byte values whose int32 sums could
    overflow, see the module note) and RuntimeError if a launch fails. The
    transposed, padded scratch copy (N rounded up to 128, T to 128, one byte
    each) and a fresh output are allocated here; nothing synchronises,
    except to read the masks' maximum from T = 33,026 uint8 tokens on.
    """
    _check(masks.ndim == 2, f"masks must be [T, N], got shape "
                            f"{tuple(masks.shape)}")
    _check(masks.dtype in MASK_DTYPES,
           f"masks must be bool or uint8, got {masks.dtype}")
    T, N = masks.shape
    _check(T < MAX_TOKENS, f"T = {T} tokens: counts past 2^24 are not exact "
                           f"in float32; accumulate in blocks")
    _check(masks.device.type == "cuda",
           f"masks are on {masks.device}, expected a CUDA device")
    if accumulate_into is not None:
        _check_into(accumulate_into, masks)
    dev = masks.device
    if T == 0 or N == 0:
        if accumulate_into is not None:
            return accumulate_into
        return torch.zeros((N, N), dtype=torch.float32, device=dev)
    m = masks.contiguous()
    if m.dtype == torch.bool:
        m = m.view(torch.uint8)
    elif T >= BYTE_VALUE_TOKENS:
        vmax = int(m.max())
        _check(int32_sums_fit(T, vmax),
               f"T = {T} tokens of byte values up to {vmax}: T·{vmax}² "
               f"passes the kernel's int32 sums (2^31 − 1; byte values above "
               f"1 from T = {BYTE_VALUE_TOKENS} on); pass 0/1 masks or "
               f"fewer tokens a block")
    Np = -(-N // TILE_N) * TILE_N
    Tp = -(-T // TILE_T) * TILE_T
    scratch = torch.empty((Np, Tp), dtype=torch.uint8, device=dev)
    out = accumulate_into
    if out is None:
        out = torch.empty((N, N), dtype=torch.float32, device=dev)
    launch = _bind(load_library("coact"))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = launch(m.data_ptr(), scratch.data_ptr(), out.data_ptr(),
                     T, N, Tp, Np, int(accumulate_into is not None), stream)
    if err != 0:
        raise RuntimeError(f"coact_accumulate kernel launch failed with "
                           f"CUDA error {err}")
    counts.launches += 1
    return out
