"""Model facade for the decoder-only models the port serves: dense
(attention + dense FFN), MoE (granite-moe), SSM (xLSTM: mLSTM / sLSTM
blocks) and hybrid (jamba: Mamba + attention + MoE). Encoder-decoder and
VLM models are not ported (ValueError).

Entry points (functions of (params, batch), like the reference's):
  init_params(generator)                     — seeded parameter init
  forward(params, batch, capture=False)      — logits, MoE aux loss
                                               (+ FFN captures)
  init_cache(batch, max_len, swa=False)      — contiguous KV cache (int8
                                               when cfg.kv_quant), or with
                                               swa the sliding-window rings;
                                               SSM sublayers' states
  init_paged_cache(num_pages, page_size)     — paged KV arenas
  prefill(params, batch, cache, window=0)    — (logits_last, cache)
  decode_step(params, tokens, position, cache, page_tables=None, window=0)
                                             — (logits, cache)

Params are nested dicts of tensors on `model.device`: {"embed": {...},
"stack": [per-group {"sub_j": {...}}], "final_norm": {...}} — the
reference's pytree with its stacked [G, ...] scan axis unstacked into a
list (`repro_torch.convert.params_from_numpy` does that conversion).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import transformer
from repro_torch.models.layers import (apply_norm, embed_tokens,
                                       init_embedding, init_norm, unembed)

Params = Dict[str, Any]


class Model:
    def __init__(self, cfg: ModelConfig, device: DeviceLike = None):
        transformer.check_supported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)

    # -- init ----------------------------------------------------------------
    def init_params(self, generator: Optional[torch.Generator] = None) -> Params:
        """Random weights with the reference init's shapes and scales, drawn
        from `generator` (default: seed 0 on the model's device). The
        numbers differ from the reference's `jax.random` draws; parity
        tests convert the reference's own params instead."""
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        if torch.device(generator.device).type != self.device.type:
            raise ValueError(f"generator is on {generator.device}, model on "
                             f"{self.device}")
        cfg = self.cfg
        return {"embed": init_embedding(generator, cfg),
                "stack": transformer.init_stack(generator, cfg),
                "final_norm": init_norm(cfg, self.device)}

    # -- forward ---------------------------------------------------------------
    def _embed_inputs(self, params: Params, batch: Dict[str, torch.Tensor]):
        tokens = batch["tokens"]
        B, S = tokens.shape
        x = embed_tokens(params["embed"], tokens, self.cfg)
        positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
        return x, positions

    def forward(self, params: Params, batch: Dict[str, torch.Tensor],
                capture_activations: bool = False, window: int = 0):
        cfg = self.cfg
        x, positions = self._embed_inputs(params, batch)
        out = transformer.stack_forward(params["stack"], x, positions, cfg,
                                        window=window,
                                        capture_activations=capture_activations)
        h = apply_norm(params["final_norm"], out.x, cfg)
        res = {"logits": unembed(params["embed"], h, cfg),
               "aux_loss": out.aux_loss, "hidden": h}
        if capture_activations:
            res["ffn_pre_act"] = out.ffn_pre_act
            res["ffn_inputs"] = out.ffn_inputs
        return res

    # -- serving -------------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int, swa: bool = False,
                   dtype=None) -> Any:
        """Per-slot caches: contiguous [batch, max_len] KV (int8 when
        `cfg.kv_quant`), or with `swa` float rings of `cfg.sliding_window`
        slots; an SSM sublayer's recurrent state."""
        return transformer.init_stack_cache(self.cfg, batch, max_len,
                                            self.device, swa=swa, dtype=dtype)

    def init_paged_cache(self, num_pages: int, page_size: int,
                         dtype=None) -> Any:
        """Paged KV arenas (attention-only stacks; see
        `transformer.init_paged_stack_cache` for the layout and the
        ValueError surface)."""
        return transformer.init_paged_stack_cache(
            self.cfg, num_pages, page_size, self.device, dtype=dtype)

    def prefill(self, params: Params, batch: Dict[str, torch.Tensor],
                cache: Any, window: int = 0) -> Tuple[torch.Tensor, Any]:
        """Dense prefill; fills `cache` in place. Returns ([B, 1, V] logits of
        the last position, cache)."""
        cfg = self.cfg
        x, positions = self._embed_inputs(params, batch)
        h, cache = transformer.stack_prefill(params["stack"], x, positions,
                                             cache, cfg, window=window)
        h = apply_norm(params["final_norm"], h[:, -1:], cfg)
        return unembed(params["embed"], h, cfg), cache

    def decode_step(self, params: Params, tokens: torch.Tensor, position,
                    cache: Any, page_tables: Optional[torch.Tensor] = None,
                    window: int = 0) -> Tuple[torch.Tensor, Any]:
        """tokens: [B, 1]; position: a scalar shared by the batch, or a [B]
        vector of per-slot positions (continuous-batching decode).
        `page_tables` [B, max_pages] int32 routes a paged cache (from
        `init_paged_cache`; per-slot positions required); `window` is a
        sliding-window cache's attention window (0: `cfg.sliding_window`).
        Updates `cache` in place."""
        cfg = self.cfg
        x = embed_tokens(params["embed"], tokens, cfg)
        h, cache = transformer.stack_decode_step(params["stack"], x, position,
                                                 cache, cfg,
                                                 page_tables=page_tables,
                                                 window=window)
        h = apply_norm(params["final_norm"], h, cfg)
        return unembed(params["embed"], h, cfg), cache


def build_model(cfg: ModelConfig, device: DeviceLike = None) -> Model:
    """The model for `cfg` on `device` (default cuda; pass "cpu" to run on
    the CPU). Raises ValueError for encoder-decoder and VLM models."""
    return Model(cfg, device=device)
