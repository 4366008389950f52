"""Contiguous KV cache and cached attention.

Unlike the reference's immutable arrays, the port preallocates each cache
once and WRITES IN PLACE: `kv_write` and `kv_write_rows` copy the new rows
into the cache tensors and return the same `KVCache` (the caller may keep
using either handle). That saves one cache-sized copy per layer per step.

Only the float contiguous cache is ported so far; the int8 (`kv_quant`),
sliding-window and paged caches raise until their slice lands.
"""
from __future__ import annotations

from typing import NamedTuple, Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import gqa_attend


class KVCache(NamedTuple):
    """Full cache: slot s holds position s. k/v: [B, S_max, KV, hd]."""
    k: torch.Tensor
    v: torch.Tensor


def init_kv_cache(batch: int, max_len: int, cfg: ModelConfig, device,
                  dtype=None) -> KVCache:
    if cfg.kv_quant:
        raise NotImplementedError(
            "int8 KV cache (kv_quant) is not ported to PyTorch yet")
    dtype = dtype or cfg.dtype()
    shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))


def kv_write(cache: KVCache, k_new: torch.Tensor, v_new: torch.Tensor,
             start: Union[int, torch.Tensor]) -> KVCache:
    """Write [B, T, KV, hd] at slots [start, start+T), in place."""
    s = int(start)
    T = k_new.shape[1]
    cache.k[:, s:s + T] = k_new.to(cache.k.dtype)
    cache.v[:, s:s + T] = v_new.to(cache.v.dtype)
    return cache


def kv_write_rows(cache: KVCache, k_new: torch.Tensor, v_new: torch.Tensor,
                  positions: torch.Tensor) -> KVCache:
    """Per-row write, in place: [B, T, KV, hd] at slots
    [positions[b], positions[b]+T).

    The continuous-batching decode path: every slot of the batch sits at its
    own sequence position, so the write start is a [B] vector instead of the
    shared scalar `kv_write` takes."""
    B, T = k_new.shape[0], k_new.shape[1]
    rows = torch.arange(B, device=k_new.device)[:, None]
    slots = (positions.long()[:, None]
             + torch.arange(T, device=k_new.device)[None])
    cache.k[rows, slots] = k_new.to(cache.k.dtype)
    cache.v[rows, slots] = v_new.to(cache.v.dtype)
    return cache


def attend_full_cache(q: torch.Tensor, cache: KVCache,
                      q_pos: torch.Tensor) -> torch.Tensor:
    """q: [B, T, H, hd] (rope applied); q_pos: [B, T]. Causal over filled
    slots."""
    B, S = cache.k.shape[0], cache.k.shape[1]
    k_pos = torch.arange(S, device=q.device)[None].expand(B, S)
    return gqa_attend(q, cache.k, cache.v, q_pos, k_pos, causal=True)
