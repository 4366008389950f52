"""Paged-KV decode attention: the Hopper kernel's wrapper and its plain
PyTorch version.

One new token per batch row attends (GQA, causal: slot <= cur_pos[b]) to
the row's KV rows, found through its page table in a page arena of public
layout [num_pages + 1, page_size, KV, hd] (the last page is the null page).
Arenas are float32, bfloat16 (a bf16 model's arena), or int8 with bf16
per-(page, offset, head) scales that are dequantised before the products.
The query is float32 and the result is f32 [B, H, hd].

`paged_decode_attention_cuda` launches the hand-written kernel in
`csrc/paged_decode.cu` (see the note there for its bound and design) as
`plan` cuts the work: one KV head a block, tiles of slots, splits of
whole tiles along the slots, and the 16-byte or the narrow (one element a
lane) load path; `paged_decode_attention_plain` is the math of the reference's
XLA twin (`ops._paged_decode_xla`): gather each row's pages into
[B, S, KV, hd], dequantise, then `gqa_attend` with positional causal
masking — so on the same slots it gives the contiguous cache's attention
bit for bit. `repro_torch.kernels.ops.paged_decode_attention` dispatches
between them by the device of the input.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels.build import Counts, load_library
from repro_torch.models.kvcache import gather_pages
from repro_torch.models.layers import gqa_attend

DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
MAX_HEAD_DIM = 256
THREADS = 256            # a block's threads (csrc: kThreads)
TILE_BYTES = 16384       # shared memory a tile of K takes (rows padded)
MAX_ROWS = 512           # slots a tile takes at most (kMaxRows)
MAX_ENTRIES = 1024       # page-table entries a split holds (kMaxEntries)

counts = Counts()   # this kernel's own launch / plain-call counters


def check_scales(k_scale: Optional[torch.Tensor],
                 v_scale: Optional[torch.Tensor]) -> None:
    if (k_scale is None) != (v_scale is None):
        raise ValueError("pass both k_scale and v_scale, or neither")


def paged_decode_attention_plain(
    q: torch.Tensor,              # [B, H, hd] query of ONE new token
    k_pages: torch.Tensor,        # [num_pages + 1, page_size, KV, hd]
    v_pages: torch.Tensor,
    page_tables: torch.Tensor,    # [B, max_pages] int
    cur_pos: torch.Tensor,        # [B] int current (query) position per row
    k_scale: Optional[torch.Tensor] = None,   # [num_pages + 1, page_size, KV]
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel (f32 [B, H, hd] out)."""
    check_scales(k_scale, v_scale)
    B, H, hd = q.shape
    S = page_tables.shape[1] * k_pages.shape[1]
    k = gather_pages(k_pages, page_tables)
    v = gather_pages(v_pages, page_tables)
    if k_scale is not None:
        k = k.float() * gather_pages(k_scale, page_tables)[..., None].float()
        v = v.float() * gather_pages(v_scale, page_tables)[..., None].float()
    k_pos = torch.arange(S, device=q.device)[None].expand(B, S)
    out = gqa_attend(q[:, None].to(k.dtype), k, v, cur_pos.long()[:, None],
                     k_pos, causal=True)
    return out[:, 0].reshape(B, H, hd).float()


def _fail(msg: str) -> None:
    raise ValueError(f"paged_decode_attention: {msg}")


def _bind(lib: ctypes.CDLL):
    fn = lib.paged_decode_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 12
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


class PagedPlan(NamedTuple):
    """How one launch cuts the work (`csrc/paged_decode.cu`'s geometry)."""
    narrow: bool         # element-wise instantiation (no 16-byte cp.async)
    mma: bool            # bf16 scores and P.V on the tensor cores
    tile: int            # slots a block takes per step
    chunk: int           # slots per split, a whole number of tiles
    splits: int          # blocks along the slots per (row, KV head)


@functools.lru_cache(maxsize=1024)
def plan(B: int, KV: int, G: int, hd: int, page_size: int, max_pages: int,
         elt: int, sms: int, aligned: bool = True,
         blocks_per_sm: int = 2) -> PagedPlan:
    """The launch's tile, split count and load width for arenas of
    `elt`-byte elements ([.., page_size, KV, hd]) and page tables of
    `max_pages` pages, on a card of `sms` SMs that holds `blocks_per_sm`
    blocks of this instantiation each; one KV head a block. The 16-byte
    path needs rows of a multiple of 16 bytes and `aligned` (both arenas'
    bases 16-byte aligned); otherwise the narrow path. bf16 rows of a
    multiple of 16 elements take the tensor cores.

    The tile: the tile unit (16 on the tensor cores; else the slots one
    score pass covers) times the largest power of two that keeps it within
    TILE_BYTES of shared memory and MAX_ROWS slots. Splits: as many as one
    wave of blocks holds (blocks_per_sm * sms over the B * KV (row, KV
    head) pairs), over the table's span of max_pages * page_size slots (the
    host does not read cur_pos); a short span takes smaller tiles to reach
    that; each split a whole number of tiles of at most MAX_ENTRIES - 1
    pages, the last one not empty."""
    narrow = not aligned or (hd * elt) % 16 != 0
    mma = elt == 2 and not narrow and hd % 16 == 0
    sve = 1 if narrow else min(16 // elt, 8)
    scpr = -(-hd // sve)
    lanes = min(32, max(4, 1 << (scpr - 1).bit_length()))
    pitch = -(-hd * elt // 16) * 16 + (16 if mma else 0)
    u = 16 if mma else THREADS // lanes
    span = max_pages * page_size
    tile = u                          # u times a power of two: splits of
    while (2 * tile * pitch <= TILE_BYTES        # a span of whole pages
           and 2 * tile <= MAX_ROWS and tile < span):       # come out even
        tile *= 2
    want = max(1, blocks_per_sm * sms // (B * KV))
    if -(-span // tile) < want:      # a short span: smaller tiles
        tile = max(u, -(-(-(-span // want)) // u) * u)
    tiles = -(-span // tile)
    max_tiles = (MAX_ENTRIES - 1) * page_size // tile
    splits = max(1, min(want, tiles), -(-tiles // max_tiles))
    chunk = -(-tiles // splits) * tile
    return PagedPlan(narrow, mma, tile, chunk, -(-span // chunk))


@functools.lru_cache(maxsize=1024)
def _occupancy(KV: int, G: int, hd: int, page_size: int, max_pages: int,
               p: PagedPlan, dtype: int, device: int) -> int:
    fn = load_library("paged_decode").paged_decode_blocks_per_sm
    fn.argtypes = [ctypes.c_int] * 10 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    n = ctypes.c_int(0)
    with torch.cuda.device(device):
        err = fn(KV, G, hd, page_size, max_pages, p.splits, p.chunk, p.tile,
                 int(p.narrow), dtype, ctypes.byref(n))
    if err != 0:
        raise RuntimeError(f"paged_decode_blocks_per_sm failed with CUDA "
                           f"error {err}")
    return n.value


def _plan_for(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
              page_tables: torch.Tensor) -> PagedPlan:
    """The plan of a launch on these inputs: first at two blocks an SM,
    then again at the occupancy CUDA reports for that plan's
    instantiation."""
    B, H, hd = q.shape
    page_size, KV = k_pages.shape[1], k_pages.shape[2]
    dev = q.device
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    key = (B, KV, H // KV, hd, page_size, page_tables.shape[1],
           k_pages.element_size(), _sm_count(index),
           k_pages.data_ptr() % 16 == 0 and v_pages.data_ptr() % 16 == 0)
    p = plan(*key)
    bps = _occupancy(KV, H // KV, hd, page_size, page_tables.shape[1], p,
                     DTYPES[k_pages.dtype], index)
    return p if bps == 2 else plan(*key, blocks_per_sm=max(1, bps))


def blocks_per_sm(q: torch.Tensor, k_pages: torch.Tensor,
                  v_pages: torch.Tensor, page_tables: torch.Tensor) -> int:
    """How many blocks of the split kernel one SM holds at once for these
    inputs (CUDA occupancy of the instantiation a launch would take)."""
    p = _plan_for(q, k_pages, v_pages, page_tables)
    KV = k_pages.shape[2]
    index = (q.device.index if q.device.index is not None
             else torch.cuda.current_device())
    return _occupancy(KV, q.shape[1] // KV, q.shape[2], k_pages.shape[1],
                      page_tables.shape[1], p, DTYPES[k_pages.dtype], index)


def paged_decode_attention_cuda(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    page_tables: torch.Tensor,
    cur_pos: torch.Tensor,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Launch the Hopper kernel on PyTorch's current stream. Validates
    device, dtype, shape and contiguity and raises ValueError on what the
    kernel does not take; raises RuntimeError if the launch fails. The
    output and the per-split partials are allocated here (one buffer), the
    merge tickets once per (device, stream); nothing synchronises, and
    `cur_pos` and the page tables are read on the device only. Page-table
    entries must name pages of the arena (the kernel traps on one that
    does not)."""
    check_scales(k_scale, v_scale)
    dev = q.device
    tensors = {"q": q, "k_pages": k_pages, "v_pages": v_pages,
               "page_tables": page_tables, "cur_pos": cur_pos}
    if k_scale is not None:
        tensors.update(k_scale=k_scale, v_scale=v_scale)
    # each message is formatted only on failure: this runs on every decode
    # step of every layer
    for name, t in tensors.items():
        if not (t.device == dev and dev.type == "cuda"):
            _fail(f"{name} is on {t.device}, expected the CUDA device {dev}")
        if not t.is_contiguous():
            _fail(f"{name} must be contiguous")
    if not (q.dtype == torch.float32 and q.ndim == 3):
        _fail("q must be f32 [B, H, hd]")
    B, H, hd = q.shape
    if k_pages.dtype not in DTYPES:
        _fail(f"arenas must be bfloat16, float32 or int8, got {k_pages.dtype}")
    if not (k_pages.ndim == 4 and k_pages.shape[-1] == hd):
        _fail("arenas must be [num_pages + 1, page_size, KV, hd]")
    if not (v_pages.dtype == k_pages.dtype
            and v_pages.shape == k_pages.shape):
        _fail("v_pages must match k_pages's dtype and shape")
    n_pages, page_size, KV, _ = k_pages.shape
    quant = k_pages.dtype == torch.int8
    if quant != (k_scale is not None):
        _fail("int8 arenas need k_scale/v_scale; float32 and bfloat16 "
              "arenas take none")
    if quant:
        for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
            if not (t.dtype == torch.bfloat16
                    and t.shape == k_pages.shape[:3]):
                _fail(f"{name} must be bf16 [num_pages + 1, page_size, KV]")
    if not (KV >= 1 and H % KV == 0):
        _fail(f"H={H} is not a multiple of KV={KV}")
    G = H // KV
    if hd > MAX_HEAD_DIM:
        _fail(f"head_dim {hd} > {MAX_HEAD_DIM}")
    if not (G <= 8 and (G <= 4 or hd <= 128)):
        _fail(f"{G} query heads per KV head at head_dim {hd}: the kernel "
              f"takes G <= 4, or G <= 8 with head_dim <= 128")
    if not (page_tables.dtype == torch.int32 and page_tables.ndim == 2
            and page_tables.shape[0] == B):
        _fail(f"page_tables must be int32 [B={B}, max_pages]")
    if not (cur_pos.dtype == torch.int32 and cur_pos.shape == (B,)):
        _fail(f"cur_pos must be int32 [B={B}]")
    max_pages = page_tables.shape[1]
    if B == 0 or H == 0 or max_pages == 0 or page_size == 0:
        return torch.zeros((B, H, hd), dtype=torch.float32, device=dev)
    p = _plan_for(q, k_pages, v_pages, page_tables)
    # the output and the splits' partials in one allocation
    buf = torch.empty(B * H * (hd + p.splits * (2 + hd)), dtype=torch.float32,
                      device=dev)
    out = buf[:B * H * hd].view(B, H, hd)
    stream = torch.cuda.current_stream(dev).cuda_stream
    tickets = _merge_tickets(B * KV, dev, stream)
    launch = _bind(load_library("paged_decode"))
    here = dev.index is None or dev.index == torch.cuda.current_device()
    with contextlib.nullcontext() if here else torch.cuda.device(dev):
        err = launch(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                     k_scale.data_ptr() if quant else None,
                     v_scale.data_ptr() if quant else None,
                     page_tables.data_ptr(), cur_pos.data_ptr(),
                     out.data_ptr() + 4 * B * H * hd, out.data_ptr(),
                     tickets.data_ptr(), B, KV, G, hd, page_size, max_pages,
                     n_pages, p.splits, p.chunk, p.tile, int(p.narrow),
                     DTYPES[k_pages.dtype], float(hd ** -0.5), stream)
    if err != 0:
        raise RuntimeError(f"paged_decode_attention kernel launch failed "
                           f"with CUDA error {err}")
    counts.launches += 1
    return out
