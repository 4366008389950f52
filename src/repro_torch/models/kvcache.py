"""KV caches (contiguous float and int8, sliding-window rings, paged float
and int8) and cached attention.

Unlike the reference's immutable arrays, the port preallocates each cache
once and WRITES IN PLACE: every `*_write*` function copies the new rows
into the cache tensors and returns the same cache object (the caller may
keep using either handle). That saves one cache-sized copy per layer per
step.

The int8 caches quantise each (slot, head) row symmetrically with a bf16
scale, bit for bit as the reference does (`torch.round` and `jnp.round`
both round half to even). The paged arenas have no batch axis: requests own
disjoint pages through per-request page tables (`serving/paging.py`), and
the last physical page is the null page that inactive slots point at. The
sliding-window ring keeps the last W positions of each row (slot = pos %
W) with their positions beside them; decode attends it through
`kernels.ops.swa_decode_attention`.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple, Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import gqa_attend


class KVCache(NamedTuple):
    """Full cache: slot s holds position s. k/v: [B, S_max, KV, hd]."""
    k: torch.Tensor
    v: torch.Tensor


class QuantKVCache(NamedTuple):
    """int8 full cache: symmetric per-(slot, head) quantisation, bf16
    scales."""
    k: torch.Tensor        # int8 [B, S_max, KV, hd]
    v: torch.Tensor
    k_scale: torch.Tensor  # bf16 [B, S_max, KV]
    v_scale: torch.Tensor


class SWACache(NamedTuple):
    """Sliding-window ring: slot = pos % W. pos: [B, W] int32 (-1 = empty)."""
    k: torch.Tensor   # [B, W, KV, hd]
    v: torch.Tensor
    pos: torch.Tensor


class PagedKVCache(NamedTuple):
    """Paged arena: physical page p, offset o holds one KV row. The last
    physical page (index num_pages) is the reserved null page: page-table
    entries of inactive slots and unallocated logical pages point at it, so
    their garbage decode writes never touch a live page."""
    k: torch.Tensor   # [num_pages + 1, page_size, KV, hd]
    v: torch.Tensor

    @property
    def page_size(self) -> int:
        return self.k.shape[1]


class PagedQuantKVCache(NamedTuple):
    """int8 paged arena with per-(page, offset, head) bf16 scales: the
    `QuantKVCache` layout cut along page boundaries, so paged int8 decode
    sees exactly the contiguous int8 path's values."""
    k: torch.Tensor        # int8 [num_pages + 1, page_size, KV, hd]
    v: torch.Tensor
    k_scale: torch.Tensor  # bf16 [num_pages + 1, page_size, KV]
    v_scale: torch.Tensor

    @property
    def page_size(self) -> int:
        return self.k.shape[1]


AnyKVCache = Union[KVCache, QuantKVCache]
AnyPagedCache = Union[PagedKVCache, PagedQuantKVCache]


def init_kv_cache(batch: int, max_len: int, cfg: ModelConfig, device,
                  dtype=None) -> KVCache:
    dtype = dtype or cfg.dtype()
    shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))


def init_swa_cache(batch: int, cfg: ModelConfig, device, dtype=None,
                   window: int = 0) -> SWACache:
    """An empty ring of width `window or cfg.sliding_window`."""
    dtype = dtype or cfg.dtype()
    W = window or cfg.sliding_window
    shape = (batch, W, cfg.n_kv_heads, cfg.head_dim)
    return SWACache(k=torch.zeros(shape, dtype=dtype, device=device),
                    v=torch.zeros(shape, dtype=dtype, device=device),
                    pos=torch.full((batch, W), -1, dtype=torch.int32,
                                   device=device))


def _int8_arrays(shape, device, scale_dtype):
    """(k, v, k_scale, v_scale) zeros: int8 rows of `shape`, scales over all
    but its last axis."""
    return (torch.zeros(shape, dtype=torch.int8, device=device),
            torch.zeros(shape, dtype=torch.int8, device=device),
            torch.zeros(shape[:-1], dtype=scale_dtype, device=device),
            torch.zeros(shape[:-1], dtype=scale_dtype, device=device))


def init_quant_kv_cache(batch: int, max_len: int, cfg: ModelConfig, device,
                        scale_dtype=torch.bfloat16) -> QuantKVCache:
    shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return QuantKVCache(*_int8_arrays(shape, device, scale_dtype))


def init_paged_kv_cache(num_pages: int, page_size: int, cfg: ModelConfig,
                        device, dtype=None) -> PagedKVCache:
    """Arena with `num_pages` allocatable pages + the trailing null page."""
    dtype = dtype or cfg.dtype()
    shape = (num_pages + 1, page_size, cfg.n_kv_heads, cfg.head_dim)
    return PagedKVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                        v=torch.zeros(shape, dtype=dtype, device=device))


def init_paged_quant_kv_cache(num_pages: int, page_size: int,
                              cfg: ModelConfig, device,
                              scale_dtype=torch.bfloat16) -> PagedQuantKVCache:
    shape = (num_pages + 1, page_size, cfg.n_kv_heads, cfg.head_dim)
    return PagedQuantKVCache(*_int8_arrays(shape, device, scale_dtype))


# -- writes (in place) ----------------------------------------------------------

def kv_write(cache: KVCache, k_new: torch.Tensor, v_new: torch.Tensor,
             start: Union[int, torch.Tensor]) -> KVCache:
    """Write [B, T, KV, hd] at slots [start, start+T), in place."""
    s = int(start)
    T = k_new.shape[1]
    cache.k[:, s:s + T] = k_new.to(cache.k.dtype)
    cache.v[:, s:s + T] = v_new.to(cache.v.dtype)
    return cache


def _row_slots(k_new: torch.Tensor, positions: torch.Tensor):
    """Per-row scatter indices for [B, T, ...] writes starting at
    positions[b]."""
    B, T = k_new.shape[0], k_new.shape[1]
    rows = torch.arange(B, device=k_new.device)[:, None]
    slots = (positions.long()[:, None]
             + torch.arange(T, device=k_new.device)[None])
    return rows, slots


def kv_write_rows(cache: KVCache, k_new: torch.Tensor, v_new: torch.Tensor,
                  positions: torch.Tensor) -> KVCache:
    """Per-row write, in place: [B, T, KV, hd] at slots
    [positions[b], positions[b]+T).

    The continuous-batching decode path: every slot of the batch sits at its
    own sequence position, so the write start is a [B] vector instead of the
    shared scalar `kv_write` takes."""
    rows, slots = _row_slots(k_new, positions)
    cache.k[rows, slots] = k_new.to(cache.k.dtype)
    cache.v[rows, slots] = v_new.to(cache.v.dtype)
    return cache


def _quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [..., hd] -> (int8 values, f32 per-row scales [...])."""
    xf = x.float()
    scale = torch.clamp_min(xf.abs().amax(dim=-1), 1e-6) / 127.0
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def quant_kv_write(cache: QuantKVCache, k_new: torch.Tensor,
                   v_new: torch.Tensor,
                   start: Union[int, torch.Tensor]) -> QuantKVCache:
    """`kv_write` for the int8 cache: quantise, then write in place."""
    s = int(start)
    T = k_new.shape[1]
    kq, ks = _quantize(k_new)
    vq, vs = _quantize(v_new)
    cache.k[:, s:s + T] = kq
    cache.v[:, s:s + T] = vq
    cache.k_scale[:, s:s + T] = ks.to(cache.k_scale.dtype)
    cache.v_scale[:, s:s + T] = vs.to(cache.v_scale.dtype)
    return cache


def quant_kv_write_rows(cache: QuantKVCache, k_new: torch.Tensor,
                        v_new: torch.Tensor,
                        positions: torch.Tensor) -> QuantKVCache:
    """Per-row variant of `quant_kv_write` (see `kv_write_rows`)."""
    kq, ks = _quantize(k_new)
    vq, vs = _quantize(v_new)
    rows, slots = _row_slots(k_new, positions)
    cache.k[rows, slots] = kq
    cache.v[rows, slots] = vq
    cache.k_scale[rows, slots] = ks.to(cache.k_scale.dtype)
    cache.v_scale[rows, slots] = vs.to(cache.v_scale.dtype)
    return cache


def swa_write(cache: SWACache, k_new: torch.Tensor, v_new: torch.Tensor,
              positions: torch.Tensor) -> SWACache:
    """Scatter [B, T, KV, hd] at ring slots positions % W, in place, and
    record the positions. positions: [B, T]. With T > W only the last W
    entries are written (the earlier ones would be overwritten)."""
    W = cache.k.shape[1]
    if k_new.shape[1] > W:
        k_new, v_new, positions = k_new[:, -W:], v_new[:, -W:], positions[:, -W:]
    positions = positions.long()
    rows = torch.arange(cache.k.shape[0], device=k_new.device)[:, None]
    slots = positions % W
    cache.k[rows, slots] = k_new.to(cache.k.dtype)
    cache.v[rows, slots] = v_new.to(cache.v.dtype)
    cache.pos[rows, slots] = positions.to(cache.pos.dtype)
    return cache


# -- cached attention -----------------------------------------------------------

def attend_full_cache(q: torch.Tensor, cache: AnyKVCache,
                      q_pos: torch.Tensor) -> torch.Tensor:
    """q: [B, T, H, hd] (rope applied); q_pos: [B, T]. Causal over filled
    slots. Accepts KVCache or QuantKVCache (dequantised to q's dtype before
    the attention products)."""
    B, S = cache.k.shape[0], cache.k.shape[1]
    k_pos = torch.arange(S, device=q.device)[None].expand(B, S)
    k, v = cache.k, cache.v
    if isinstance(cache, QuantKVCache):
        k = k.to(q.dtype) * cache.k_scale[..., None].to(q.dtype)
        v = v.to(q.dtype) * cache.v_scale[..., None].to(q.dtype)
    return gqa_attend(q, k, v, q_pos, k_pos, causal=True)


def attend_swa_cache(q: torch.Tensor, cache: SWACache, q_pos: torch.Tensor,
                     window: int) -> torch.Tensor:
    """Sliding-window attention against the ring (the reference's jnp
    formulation; decode goes through `ops.swa_decode_attention`)."""
    return gqa_attend(q, cache.k, cache.v, q_pos, cache.pos.long(),
                      k_valid=cache.pos >= 0, causal=True, window=window)


# -- paged writes / attention ----------------------------------------------------

def paged_targets(positions: torch.Tensor, page_tables: torch.Tensor,
                  page_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(physical page, offset) write target per batch row for a one-token
    decode write at `positions[b]`. Inactive rows' page tables point every
    logical page at the null page, so their garbage writes collide there
    harmlessly instead of hitting a live page. One decode step computes this
    once for all layers: every arena shares the page tables."""
    pos = positions.long()
    rows = torch.arange(page_tables.shape[0], device=page_tables.device)
    phys = page_tables[rows, pos // page_size].long()
    return phys, pos % page_size


def paged_kv_write_rows(cache: PagedKVCache, k_new: torch.Tensor,
                        v_new: torch.Tensor,
                        targets: Tuple[torch.Tensor, torch.Tensor]
                        ) -> PagedKVCache:
    """Page-scatter decode write, in place: [B, 1, KV, hd] at the
    `paged_targets` (page, offset) of each row. The paged twin of
    `kv_write_rows` (one token per slot per step; prompt pages are
    block-copied by `PagePool.write_prompt`)."""
    if k_new.shape[1] != 1:
        raise ValueError("paged decode writes one token per step")
    phys, off = targets
    cache.k[phys, off] = k_new[:, 0].to(cache.k.dtype)
    cache.v[phys, off] = v_new[:, 0].to(cache.v.dtype)
    return cache


def paged_quant_kv_write_rows(cache: PagedQuantKVCache, k_new: torch.Tensor,
                              v_new: torch.Tensor,
                              targets: Tuple[torch.Tensor, torch.Tensor]
                              ) -> PagedQuantKVCache:
    """Paged twin of `quant_kv_write_rows`: the same per-row symmetric int8
    quantisation, scattered to (page, offset) instead of (row, slot)."""
    if k_new.shape[1] != 1:
        raise ValueError("paged decode writes one token per step")
    kq, ks = _quantize(k_new[:, 0])
    vq, vs = _quantize(v_new[:, 0])
    phys, off = targets
    cache.k[phys, off] = kq
    cache.v[phys, off] = vq
    cache.k_scale[phys, off] = ks.to(cache.k_scale.dtype)
    cache.v_scale[phys, off] = vs.to(cache.v_scale.dtype)
    return cache


def gather_pages(arena: torch.Tensor, page_tables: torch.Tensor
                 ) -> torch.Tensor:
    """[P+1, page_size, ...] arena -> [B, max_pages * page_size, ...]: each
    row's pages in logical order, so slot s holds position s."""
    B, n = page_tables.shape
    g = arena[page_tables.long()]
    return g.reshape((B, n * arena.shape[1]) + tuple(arena.shape[2:]))


def paged_gather_kv(cache: AnyPagedCache, page_tables: torch.Tensor):
    """Gather each row's pages into a contiguous [B, S, KV, hd] view
    (S = max_pages * page_size), the layout `attend_full_cache` sees.
    Gathered rows past a request's current position hold whatever the page
    last held (null-page trash for unallocated logical pages); causal
    masking hides them as it hides stale contiguous-cache slots. Returns
    (k, v) or, for the int8 arena, (k, v, k_scale, v_scale)."""
    return tuple(gather_pages(a, page_tables) for a in cache)


def attend_paged_cache(q: torch.Tensor, cache: AnyPagedCache,
                       q_pos: torch.Tensor,
                       page_tables: torch.Tensor) -> torch.Tensor:
    """Paged twin of `attend_full_cache`: gather pages, then the identical
    causal GQA math (same masking, same contraction order), so a paged
    layout reproduces the contiguous cache bitwise when both span the same
    number of slots. Accepts PagedKVCache or PagedQuantKVCache (dequantised
    after the gather, before attention, as the contiguous int8 path does)."""
    B = q.shape[0]
    S = page_tables.shape[1] * cache.page_size
    k_pos = torch.arange(S, device=q.device)[None].expand(B, S)
    if isinstance(cache, PagedQuantKVCache):
        k, v, ks, vs = paged_gather_kv(cache, page_tables)
        k = k.to(q.dtype) * ks[..., None].to(q.dtype)
        v = v.to(q.dtype) * vs[..., None].to(q.dtype)
    else:
        k, v = paged_gather_kv(cache, page_tables)
    return gqa_attend(q, k, v, q_pos, k_pos, causal=True)
