"""Sliding-window decode attention over a ring: the Hopper kernel's wrapper
and its plain PyTorch version.

One new token per batch row attends (GQA) to the row's ring of W slots in
the reference's layout [B, W, KV, hd]; slot w holds position pos[b, w]
(-1 = empty) and takes part iff

    pos >= 0  and  cur - window < pos <= cur

with `cur` the query's position: one scalar for the whole batch (the TPU
kernel's form) or one per row (the continuous-batching server, where every
slot sits at its own position). A row with no valid slot gives 0. Rings
are float32 or bfloat16; q has their dtype, or is float32 over bf16 rings
(a bf16 model served offload: the offloaded FFN makes its residual stream
float32). The result has q's dtype. Scores are float32 from the unrounded
q and the ring's values upcast, as the reference's promotion does.

`swa_decode_attention_cuda` launches the hand-written kernel in
`csrc/swa_decode.cu` (see the note there for its bound and design) as
`plan` cuts the rings: tiles of slots, splits of whole tiles along W, and
the 16-byte or the narrow (one element a lane) load path;
`swa_decode_attention_plain` is the reference oracle's math
(`ref.swa_decode_ref`) in the same order: float32 scores, masked to -1e30,
softmax, the value product with P in float32, zeros for an empty row. On
bf16 rings the kernel's tensor-core path rounds P to bf16 for P.V, as the
TPU kernel does (`p.astype(v.dtype)`); the plain version keeps the
oracle's float32 P, so the two agree to one bf16 rounding of P (2e-2).
`repro_torch.kernels.ops.swa_decode_attention` dispatches between them by
the device of the input.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple, Tuple, Union

import torch

from repro_torch.kernels.build import Counts, load_library

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256
THREADS = 256            # a block's threads (csrc: kThreads)
PASSES = 4               # slot passes per tile (csrc: kPasses)
BLOCKS_PER_SM = 4        # split target: enough blocks in flight per SM
MIN_TILES = 4            # tiles a split takes at least, where W allows
MAX_CHUNK = 2048         # slots a split takes at most (csrc: kMaxChunk)

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


def _dtype_code(q: torch.Tensor, k_cache: torch.Tensor) -> int:
    """The launch's `dtype`: the rings' (q alike), or 2 for a float32 q
    over bf16 rings."""
    return DTYPES[q.dtype] if q.dtype == k_cache.dtype else 2


def _fail(msg: str) -> None:
    raise ValueError(f"swa_decode_attention: {msg}")


def _bind(lib: ctypes.CDLL):
    fn = lib.swa_decode_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 12
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


_tickets: Dict[Tuple[torch.device, int], torch.Tensor] = {}


def _merge_tickets(n: int, dev: torch.device, stream: int) -> torch.Tensor:
    """int32 [>= n] of zeros on `dev` for launches on `stream` (a
    cudaStream_t): the kernel's merge tickets, which every launch leaves at
    zero again, so they are allocated once per stream. Launches on two
    streams may overlap, so they never share tickets."""
    t = _tickets.get((dev, stream))
    if t is None or t.numel() < n:
        t = _tickets[dev, stream] = torch.zeros(max(n, 64), dtype=torch.int32,
                                                device=dev)
    return t


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


class SwaPlan(NamedTuple):
    """How one launch cuts the rings (`csrc/swa_decode.cu`'s geometry)."""
    narrow: bool     # element-wise instantiation (no 16-byte cp.async)
    tile: int        # slots a block takes per step
    chunk: int       # slots per split, a whole number of tiles
    splits: int      # blocks along W per (row, KV head); none is empty


@functools.lru_cache(maxsize=1024)
def plan(B: int, KV: int, G: int, hd: int, W: int, elt: int, sms: int,
         aligned: bool = True) -> SwaPlan:
    """The launch's tile, split count and load width for rings [B, W, KV,
    hd] of `elt`-byte elements on a card of `sms` SMs. The 16-byte path
    needs rows of a multiple of 16 bytes and `aligned` (both rings' bases
    16-byte aligned); otherwise the narrow path. The tile is THREADS *
    PASSES / lanes slots, lanes being the threads that share a row's
    chunks (the kernel's `geometry`). Splits: enough for BLOCKS_PER_SM
    blocks on every SM, each at least MIN_TILES tiles where W allows and
    at most MAX_CHUNK slots, every split a whole number of tiles, and the
    last one not empty."""
    narrow = not aligned or (hd * elt) % 16 != 0
    chunks = hd if narrow else hd * elt // 16
    lanes = min(32, max(4, 1 << (chunks - 1).bit_length()))
    tile = THREADS * PASSES // lanes
    tiles = max(1, -(-W // tile))
    want = -(-BLOCKS_PER_SM * sms // max(B * KV, 1))
    splits = max(1, min(want, tiles // MIN_TILES),
                 -(-tiles // (MAX_CHUNK // tile)))
    chunk = -(-tiles // splits) * tile
    return SwaPlan(narrow, tile, chunk, max(1, -(-W // chunk)))


def _plan_for(q: torch.Tensor, k_cache: torch.Tensor,
              v_cache: torch.Tensor) -> SwaPlan:
    B, H, hd = q.shape
    W, KV = k_cache.shape[1], k_cache.shape[2]
    dev = q.device
    return plan(B, KV, H // KV, hd, W, k_cache.element_size(),
                _sm_count(dev.index if dev.index is not None
                          else torch.cuda.current_device()),
                aligned=k_cache.data_ptr() % 16 == 0
                and v_cache.data_ptr() % 16 == 0)


def blocks_per_sm(q: torch.Tensor, k_cache: torch.Tensor,
                  v_cache: torch.Tensor) -> int:
    """How many blocks of the split kernel one SM holds at once for these
    inputs (CUDA occupancy of the instantiation a launch would take)."""
    p = _plan_for(q, k_cache, v_cache)
    fn = load_library("swa_decode").swa_decode_blocks_per_sm
    fn.argtypes = [ctypes.c_int] * 7 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    n = ctypes.c_int(0)
    with torch.cuda.device(q.device):
        err = fn(q.shape[1] // k_cache.shape[2], q.shape[2], k_cache.shape[1],
                 p.chunk, p.tile, int(p.narrow), _dtype_code(q, k_cache),
                 ctypes.byref(n))
    if err != 0:
        raise RuntimeError(f"swa_decode_blocks_per_sm failed with CUDA "
                           f"error {err}")
    return n.value


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
    and the per-split partials (one scratch buffer) are allocated here, the
    merge tickets once per device; nothing synchronises. A Python int
    `cur_pos` is copied to the device; a tensor is read there ([] for the
    whole batch, [B] per row). Rings whose rows are not a multiple of 16
    bytes, or whose base is not 16-byte aligned, take the kernel's narrow
    path."""
    dev = q.device
    if not isinstance(cur_pos, torch.Tensor):
        cur_pos = torch.tensor(int(cur_pos), dtype=torch.int32, device=dev)
    tensors = {"q": q, "k_cache": k_cache, "v_cache": v_cache, "pos": pos,
               "cur_pos": cur_pos}
    for name, t in tensors.items():
        if not (t.device == dev and dev.type == "cuda"):
            _fail(f"{name} is on {t.device}, expected the CUDA device {dev}")
        if not t.is_contiguous():
            _fail(f"{name} must be contiguous")
    if not (q.dtype in DTYPES and q.ndim == 3):
        _fail(f"q must be float32 or bfloat16 [B, H, hd], got {q.dtype} "
              f"{tuple(q.shape)}")
    B, H, hd = q.shape
    if not (k_cache.ndim == 4 and k_cache.shape[0] == B
            and k_cache.shape[-1] == hd):
        _fail(f"rings must be [B={B}, W, KV, hd={hd}]")
    if not (v_cache.dtype == k_cache.dtype
            and v_cache.shape == k_cache.shape):
        _fail("v_cache must match k_cache's dtype and shape")
    if k_cache.dtype not in (q.dtype, torch.bfloat16) or \
            q.dtype not in (k_cache.dtype, torch.float32):
        _fail(f"rings must have q's dtype, or be bfloat16 under a float32 "
              f"q; got q {q.dtype}, rings {k_cache.dtype}")
    _, W, KV, _ = k_cache.shape
    if not (pos.dtype == torch.int32 and tuple(pos.shape) == (B, W)):
        _fail(f"pos must be int32 [B={B}, W={W}]")
    if not (cur_pos.dtype == torch.int32 and (
            cur_pos.ndim == 0 or tuple(cur_pos.shape) == (B,))):
        _fail(f"cur_pos must be an int, or an int32 tensor [] or [B={B}]")
    if not (KV >= 1 and H % KV == 0):
        _fail(f"H={H} is not a multiple of KV={KV}")
    G = H // KV
    if hd > MAX_HEAD_DIM:
        _fail(f"head_dim {hd} > {MAX_HEAD_DIM}")
    if not (G <= 8 and (G <= 4 or hd <= 128)):
        _fail(f"{G} query heads per KV head at head_dim {hd}: the kernel "
              f"takes G <= 4, or G <= 8 with head_dim <= 128")
    out = torch.empty_like(q)
    if B == 0 or H == 0 or W == 0:
        return out.zero_()
    p = _plan_for(q, k_cache, v_cache)
    scratch = torch.empty(B * H * p.splits * (2 + hd), dtype=torch.float32,
                          device=dev)
    launch = _bind(load_library("swa_decode"))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = launch(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                     pos.data_ptr(), cur_pos.data_ptr(), scratch.data_ptr(),
                     out.data_ptr(),
                     _merge_tickets(B * KV, dev, stream).data_ptr(),
                     int(cur_pos.ndim == 1), B, W, KV, G, hd,
                     int(window), p.splits, p.chunk, p.tile, int(p.narrow),
                     _dtype_code(q, k_cache), float(hd ** -0.5), stream)
    if err != 0:
        raise RuntimeError(f"swa_decode_attention kernel launch failed with "
                           f"CUDA error {err}")
    counts.launches += 1
    return out
