"""Sliding-window decode attention over a ring: the Hopper kernel's wrapper
and its plain PyTorch version.

One new token per batch row attends (GQA) to the row's ring of W slots in
the reference's layout [B, W, KV, hd]; slot w holds position pos[b, w]
(-1 = empty) and takes part iff

    pos >= 0  and  cur - window < pos <= cur

with `cur` the query's position: one scalar for the whole batch (the TPU
kernel's form) or one per row (the continuous-batching server, where every
slot sits at its own position). A row with no valid slot gives 0. Ring and
query are float32 or bfloat16 (all three alike); the result has q's dtype.

`swa_decode_attention_cuda` launches the hand-written kernel in
`csrc/swa_decode.cu` (see the note there for its bound and design);
`swa_decode_attention_plain` is the reference oracle's math
(`ref.swa_decode_ref`) in the same order: float32 scores, masked to -1e30,
softmax, the value product, zeros for an empty row.
`repro_torch.kernels.ops.swa_decode_attention` dispatches between them by
the device of the input.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Union

import torch

from repro_torch.kernels.build import Counts, load_library

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256
SLOTS_PER_PASS = 32      # slots a block's 8 warps take per pass (8 x 4 rows)
BLOCKS_PER_SM = 4        # split target: enough blocks in flight per SM

counts = Counts()   # this kernel's own launch / plain-call counters

CurPos = Union[int, torch.Tensor]


def _cur_rows(cur_pos: CurPos, B: int, device) -> torch.Tensor:
    """`cur_pos` as a [B, 1] int64 tensor (scalar broadcast to every row)."""
    cur = torch.as_tensor(cur_pos, device=device).long()
    if cur.ndim == 0:
        return cur.reshape(1, 1).expand(B, 1)
    if tuple(cur.shape) != (B,):
        raise ValueError(f"swa_decode_attention: cur_pos must be a scalar or "
                         f"[B={B}], got shape {tuple(cur.shape)}")
    return cur[:, None]


def swa_decode_attention_plain(
    q: torch.Tensor,              # [B, H, hd] query of ONE new token
    k_cache: torch.Tensor,        # [B, W, KV, hd] ring
    v_cache: torch.Tensor,
    pos: torch.Tensor,            # [B, W] int position per slot (-1 empty)
    cur_pos: CurPos,              # scalar, or [B] per-row query positions
    *,
    window: int,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel ([B, H, hd] in q's dtype)."""
    B, H, hd = q.shape
    KV = k_cache.shape[2]
    qg = q.reshape(B, KV, H // KV, hd).float()
    s = torch.einsum("bkgh,bwkh->bkgw", qg, k_cache.float()) * hd ** -0.5
    cur = _cur_rows(cur_pos, B, q.device)
    p64 = pos.long()
    valid = (p64 >= 0) & (p64 > cur - window) & (p64 <= cur)       # [B, W]
    s = torch.where(valid[:, None, None, :], s, -1e30)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgw,bwkh->bkgh", p, v_cache.float())
    # an all-masked row softmaxes to uniform weights: zero it
    out = torch.where(valid.any(-1)[:, None, None, None], out, 0.0)
    return out.reshape(B, H, hd).to(q.dtype)


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"swa_decode_attention: {msg}")


def _bind(lib: ctypes.CDLL):
    fn = lib.swa_decode_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 9
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def n_splits(B: int, KV: int, W: int, sms: int) -> int:
    """Blocks each (row, KV head) ring is split into: enough for
    BLOCKS_PER_SM blocks on every SM, and no block with fewer than
    SLOTS_PER_PASS * 8 slots."""
    want = -(-BLOCKS_PER_SM * sms // max(B * KV, 1))
    most = max(1, -(-W // (SLOTS_PER_PASS * 8)))
    return max(1, min(want, most))


def swa_decode_attention_cuda(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    pos: torch.Tensor,
    cur_pos: CurPos,
    *,
    window: int,
) -> torch.Tensor:
    """Launch the Hopper kernel on PyTorch's current stream. Validates
    device, dtype, shape and contiguity and raises ValueError on what the
    kernel does not take; raises RuntimeError if a launch fails. The output
    and the per-split partials are allocated here; nothing synchronises.
    A Python int `cur_pos` is copied to the device; a tensor is read there
    ([] for the whole batch, [B] per row)."""
    dev = q.device
    if not isinstance(cur_pos, torch.Tensor):
        cur_pos = torch.tensor(int(cur_pos), dtype=torch.int32, device=dev)
    tensors = {"q": q, "k_cache": k_cache, "v_cache": v_cache, "pos": pos,
               "cur_pos": cur_pos}
    for name, t in tensors.items():
        _check(t.device == dev and dev.type == "cuda",
               f"{name} is on {t.device}, expected the CUDA device {dev}")
        _check(t.is_contiguous(), f"{name} must be contiguous")
    _check(q.dtype in DTYPES and q.ndim == 3,
           f"q must be float32 or bfloat16 [B, H, hd], got {q.dtype} "
           f"{tuple(q.shape)}")
    B, H, hd = q.shape
    _check(k_cache.ndim == 4 and k_cache.shape[0] == B
           and k_cache.shape[-1] == hd, f"rings must be [B={B}, W, KV, hd={hd}]")
    for name in ("k_cache", "v_cache"):
        _check(tensors[name].dtype == q.dtype
               and tensors[name].shape == k_cache.shape,
               f"{name} must match q's dtype and k_cache's shape")
    _, W, KV, _ = k_cache.shape
    _check(pos.dtype == torch.int32 and tuple(pos.shape) == (B, W),
           f"pos must be int32 [B={B}, W={W}]")
    _check(cur_pos.dtype == torch.int32 and (
        cur_pos.ndim == 0 or tuple(cur_pos.shape) == (B,)),
        f"cur_pos must be an int, or an int32 tensor [] or [B={B}]")
    _check(KV >= 1 and H % KV == 0, f"H={H} is not a multiple of KV={KV}")
    G = H // KV
    _check(hd <= MAX_HEAD_DIM, f"head_dim {hd} > {MAX_HEAD_DIM}")
    _check(G <= 8 and (G <= 4 or hd <= 128),
           f"{G} query heads per KV head at head_dim {hd}: the kernel takes "
           f"G <= 4, or G <= 8 with head_dim <= 128")
    out = torch.empty_like(q)
    if B == 0 or H == 0:
        return out
    splits = n_splits(B, KV, W, _sm_count(dev.index if dev.index is not None
                                          else torch.cuda.current_device()))
    part_ml = torch.empty((2, B, H, splits), dtype=torch.float32, device=dev)
    part_acc = torch.empty((B, H, splits, hd), dtype=torch.float32, device=dev)
    launch = _bind(load_library("swa_decode"))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = launch(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                     pos.data_ptr(), cur_pos.data_ptr(), part_ml.data_ptr(),
                     part_acc.data_ptr(), out.data_ptr(),
                     int(cur_pos.ndim == 1), B, W, KV, G, hd, int(window),
                     splits, DTYPES[q.dtype], float(hd ** -0.5), stream)
    if err != 0:
        raise RuntimeError(f"swa_decode_attention kernel launch failed with "
                           f"CUDA error {err}")
    counts.launches += 1
    return out
