"""Paged-KV decode attention: the Hopper kernel's wrapper and its plain
PyTorch version.

One new token per batch row attends (GQA, causal: slot <= cur_pos[b]) to
the row's KV rows, found through its page table in a page arena of public
layout [num_pages + 1, page_size, KV, hd] (the last page is the null page).
Arenas are float32, or int8 with bf16 per-(page, offset, head) scales that
are dequantised before the products. The result is f32 [B, H, hd].

`paged_decode_attention_cuda` launches the hand-written kernel in
`csrc/paged_decode.cu` (see the note there for its bound and design);
`paged_decode_attention_plain` is the math of the reference's XLA twin
(`ops._paged_decode_xla`): gather each row's pages into [B, S, KV, hd],
dequantise, then `gqa_attend` with positional causal masking — so on the
same slots it gives the contiguous cache's attention bit for bit.
`repro_torch.kernels.ops.paged_decode_attention` dispatches between them by
the device of the input.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels.build import Counts, load_library
from repro_torch.models.kvcache import gather_pages
from repro_torch.models.layers import gqa_attend

ARENA_DTYPES = (torch.float32, torch.int8)
MAX_HEAD_DIM = 256

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


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"paged_decode_attention: {msg}")


def _bind(lib: ctypes.CDLL):
    fn = lib.paged_decode_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


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
    output is allocated here; nothing synchronises, and `cur_pos` and the
    page tables are read on the device only. Page-table entries must name
    pages of the arena (the kernel traps on one that does not)."""
    check_scales(k_scale, v_scale)
    dev = q.device
    tensors = {"q": q, "k_pages": k_pages, "v_pages": v_pages,
               "page_tables": page_tables, "cur_pos": cur_pos}
    if k_scale is not None:
        tensors.update(k_scale=k_scale, v_scale=v_scale)
    for name, t in tensors.items():
        _check(t.device == dev and dev.type == "cuda",
               f"{name} is on {t.device}, expected the CUDA device {dev}")
        _check(t.is_contiguous(), f"{name} must be contiguous")
    _check(q.dtype == torch.float32 and q.ndim == 3, "q must be f32 [B, H, hd]")
    B, H, hd = q.shape
    _check(k_pages.dtype in ARENA_DTYPES,
           f"arenas must be float32 or int8, got {k_pages.dtype}")
    _check(k_pages.ndim == 4 and k_pages.shape[-1] == hd,
           "arenas must be [num_pages + 1, page_size, KV, hd]")
    _check(v_pages.dtype == k_pages.dtype and v_pages.shape == k_pages.shape,
           "v_pages must match k_pages's dtype and shape")
    n_pages, page_size, KV, _ = k_pages.shape
    quant = k_pages.dtype == torch.int8
    _check(quant == (k_scale is not None),
           "int8 arenas need k_scale/v_scale; float32 arenas take none")
    if quant:
        for name in ("k_scale", "v_scale"):
            t = tensors[name]
            _check(t.dtype == torch.bfloat16 and
                   tuple(t.shape) == tuple(k_pages.shape[:3]),
                   f"{name} must be bf16 [num_pages + 1, page_size, KV]")
    _check(KV >= 1 and H % KV == 0, f"H={H} is not a multiple of KV={KV}")
    G = H // KV
    _check(hd <= MAX_HEAD_DIM, f"head_dim {hd} > {MAX_HEAD_DIM}")
    _check(G <= 8 and (G <= 4 or hd <= 128),
           f"{G} query heads per KV head at head_dim {hd}: the kernel takes "
           f"G <= 4, or G <= 8 with head_dim <= 128")
    _check(page_tables.dtype == torch.int32 and page_tables.ndim == 2
           and page_tables.shape[0] == B,
           f"page_tables must be int32 [B={B}, max_pages]")
    _check(cur_pos.dtype == torch.int32 and tuple(cur_pos.shape) == (B,),
           f"cur_pos must be int32 [B={B}]")
    max_pages = page_tables.shape[1]
    out = torch.empty((B, H, hd), dtype=torch.float32, device=dev)
    if B == 0 or H == 0:
        return out
    launch = _bind(load_library("paged_decode"))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = launch(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                     k_scale.data_ptr() if quant else None,
                     v_scale.data_ptr() if quant else None,
                     page_tables.data_ptr(), cur_pos.data_ptr(),
                     out.data_ptr(), B, KV, G, hd, page_size, max_pages,
                     n_pages, float(hd ** -0.5), int(quant), stream)
    if err != 0:
        raise RuntimeError(f"paged_decode_attention kernel launch failed "
                           f"with CUDA error {err}")
    counts.launches += 1
    return out
