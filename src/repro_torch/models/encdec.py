"""Encoder-decoder stack (seamless-m4t family).

Encoder: stub frontend frames [B, F, d_frontend] through `frontend_proj`,
then bidirectional self-attention + FFN layers and a final norm (the
conv / mel frontend itself is a stub, as in the reference). Decoder: causal
self-attention (cached), cross-attention to the encoder memory (its K/V
computed once at prefill), FFN, and the decoder's own final norm — the
model-level final norm belongs to decoder-only stacks.

The reference scans both stacks over layer parameters stacked [L, ...];
the port holds them as lists (`p["layers"][l]`), and its decoder cache
holds one self-attention cache and one memory K/V pair per layer. Caches
are written in place, as `models/kvcache.py` does. Decode attention over a
sliding-window ring goes through `kernels.ops.swa_decode_attention` with
the shared scalar position (the TPU kernel's own form; the hand-written
kernel on the card).
"""
from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.dtensor import batch_placed
from repro_torch.models.kvcache import (KVCache, SWACache, attend_full_cache,
                                        init_kv_cache, init_swa_cache,
                                        kv_write, swa_attend, swa_write)
from repro_torch.models.layers import (_normal, _project_qkv, apply_norm,
                                       attention_forward,
                                       cross_attention_forward, ffn_forward,
                                       init_attention, init_ffn, init_norm,
                                       maybe_checkpoint, project_memory_kv,
                                       rope)

Params = Dict[str, Any]


def init_encoder(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """`frontend_proj` [d_frontend, d_model], `n_enc_layers` layers and the
    final norm, drawn from `gen` (the reference draws `frontend_proj` from
    `fold_in(key, 99)`; parity tests convert its params instead)."""
    dev = gen.device
    layers = [{"norm1": init_norm(cfg, dev), "attn": init_attention(gen, cfg),
               "norm2": init_norm(cfg, dev), "ffn": init_ffn(gen, cfg)}
              for _ in range(cfg.n_enc_layers)]
    return {"frontend_proj": _normal(gen, (cfg.d_frontend, cfg.d_model),
                                     cfg.pdtype(), cfg.d_frontend ** -0.5),
            "layers": layers, "final_norm": init_norm(cfg, dev)}


def encoder_forward(p: Params, frames: torch.Tensor,
                    cfg: ModelConfig) -> torch.Tensor:
    """frames: [B, F, d_frontend] stub features -> [B, F, d_model] memory."""
    x = batch_placed(frames.to(cfg.dtype())
                     @ p["frontend_proj"].to(cfg.dtype()), like=frames)
    B, F = x.shape[0], x.shape[1]
    positions = torch.arange(F, device=x.device)[None].expand(B, F)

    def layer_fn(h, lp):
        a, _, _ = attention_forward(lp["attn"], apply_norm(lp["norm1"], h, cfg),
                                    positions, cfg, causal=False)
        h = h + a
        y, _ = ffn_forward(lp["ffn"], apply_norm(lp["norm2"], h, cfg), cfg)
        return h + y

    for lp in p["layers"]:
        x = batch_placed(maybe_checkpoint(cfg, layer_fn, x, lp), like=x)
    return apply_norm(p["final_norm"], x, cfg)


def init_decoder(gen: torch.Generator, cfg: ModelConfig) -> Params:
    dev = gen.device
    layers = [{"norm1": init_norm(cfg, dev),
               "self_attn": init_attention(gen, cfg),
               "norm_x": init_norm(cfg, dev),
               "cross_attn": init_attention(gen, cfg, cross=True),
               "norm2": init_norm(cfg, dev), "ffn": init_ffn(gen, cfg)}
              for _ in range(cfg.n_layers)]
    return {"layers": layers, "final_norm": init_norm(cfg, dev)}


def _cross_and_ffn(lp: Params, h: torch.Tensor, mk: torch.Tensor,
                   mv: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """A decoder layer after its self-attention: cross-attention over the
    memory K/V, then the FFN, each added to the residual."""
    h = h + cross_attention_forward(lp["cross_attn"],
                                    apply_norm(lp["norm_x"], h, cfg), mk, mv,
                                    cfg)
    y, _ = ffn_forward(lp["ffn"], apply_norm(lp["norm2"], h, cfg), cfg)
    return h + y


def decoder_forward(p: Params, x: torch.Tensor, positions: torch.Tensor,
                    memory: torch.Tensor, cfg: ModelConfig,
                    window: int = 0) -> torch.Tensor:
    """Teacher-forced decode over the whole target sequence (training)."""

    def layer_fn(h, lp):
        a, _, _ = attention_forward(lp["self_attn"],
                                    apply_norm(lp["norm1"], h, cfg),
                                    positions, cfg, causal=True, window=window)
        mk, mv = project_memory_kv(lp["cross_attn"], memory, cfg)
        return _cross_and_ffn(lp, h + a, mk, mv, cfg)

    for lp in p["layers"]:
        x = batch_placed(maybe_checkpoint(cfg, layer_fn, x, lp), like=x)
    return apply_norm(p["final_norm"], x, cfg)


class DecoderCache(NamedTuple):
    """Per decoder layer: a self-attention cache (`KVCache`, or with `swa`
    a `SWACache` ring) and the memory K/V [B, F, KV, hd] that prefill
    stores."""
    self_kv: List[Any]
    mem_k: List[torch.Tensor]
    mem_v: List[torch.Tensor]


def init_decoder_cache(cfg: ModelConfig, batch: int, max_len: int,
                       n_frames: int, device, swa: bool = False,
                       dtype=None) -> DecoderCache:
    dtype = dtype or cfg.dtype()
    L = cfg.n_layers
    self_kv = [init_swa_cache(batch, cfg, device, dtype) if swa
               else init_kv_cache(batch, max_len, cfg, device, dtype)
               for _ in range(L)]
    shape = (batch, n_frames, cfg.n_kv_heads, cfg.head_dim)
    return DecoderCache(
        self_kv=self_kv,
        mem_k=[torch.zeros(shape, dtype=dtype, device=device)
               for _ in range(L)],
        mem_v=[torch.zeros(shape, dtype=dtype, device=device)
               for _ in range(L)])


def decoder_prefill(p: Params, x: torch.Tensor, positions: torch.Tensor,
                    memory: torch.Tensor, cache: DecoderCache,
                    cfg: ModelConfig, window: int = 0
                    ) -> Tuple[torch.Tensor, DecoderCache]:
    """Fill each layer's self-attention cache with the prompt (from slot 0,
    or ring slots pos % W) and store its memory K/V; returns the decoder's
    final-normed hidden states and the cache."""
    h = x
    for l, lp in enumerate(p["layers"]):
        a, k, v = attention_forward(lp["self_attn"],
                                    apply_norm(lp["norm1"], h, cfg),
                                    positions, cfg, causal=True, window=window)
        kv = cache.self_kv[l]
        if isinstance(kv, SWACache):
            swa_write(kv, k, v, positions)
        else:
            kv_write(kv, k, v, 0)
        mk, mv = project_memory_kv(lp["cross_attn"], memory, cfg)
        cache.mem_k[l], cache.mem_v[l] = mk, mv
        h = _cross_and_ffn(lp, h + a, mk, mv, cfg)
    return apply_norm(p["final_norm"], h, cfg), cache


def decoder_decode_step(p: Params, x: torch.Tensor, position,
                        cache: DecoderCache, cfg: ModelConfig,
                        window: int = 0) -> Tuple[torch.Tensor, DecoderCache]:
    """One token [B, 1, d] at the batch's shared scalar `position`. A ring
    is attended through `ops.swa_decode_attention` (scalar cur, window
    `window or cfg.sliding_window`), a contiguous cache through
    `attend_full_cache`."""
    B = x.shape[0]
    pos = torch.as_tensor(position, device=x.device)
    if pos.ndim != 0:
        raise ValueError("the encoder-decoder decode step takes one scalar "
                         "position shared by the batch")
    pos_arr = pos.long().reshape(1, 1).expand(B, 1)
    cur = pos.to(torch.int32)
    h = x
    for l, lp in enumerate(p["layers"]):
        normed = apply_norm(lp["norm1"], h, cfg)
        q, k, v = _project_qkv(lp["self_attn"], normed, normed, cfg)
        q = rope(q, pos_arr, cfg.rope_theta)
        k = rope(k, pos_arr, cfg.rope_theta)
        kv = cache.self_kv[l]
        if isinstance(kv, SWACache):
            swa_write(kv, k, v, pos_arr)
            out = swa_attend(q[:, 0].contiguous(), kv, cur,
                             window or cfg.sliding_window)
            a = out.reshape(B, 1, -1)
        elif isinstance(kv, KVCache):
            kv_write(kv, k, v, position)
            a = attend_full_cache(q, kv, pos_arr)
        else:
            raise ValueError(f"unsupported decoder cache "
                             f"{type(kv).__name__}")
        h = _cross_and_ffn(lp, h + a @ lp["self_attn"]["wo"],
                           cache.mem_k[l], cache.mem_v[l], cfg)
    return apply_norm(p["final_norm"], h, cfg), cache

