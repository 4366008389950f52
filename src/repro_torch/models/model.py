"""Model facade for every family the port has: decoder-only dense
(attention + dense FFN), MoE (granite-moe), SSM (xLSTM: mLSTM / sLSTM
blocks), hybrid (jamba: Mamba + attention + MoE), the VLM (a projected
patch-feature prefix before the text, internvl2) and the encoder-decoder
(seamless-m4t: `models/encdec.py`).

Entry points (functions of (params, batch), like the reference's):
  init_params(generator)                     — seeded parameter init
  forward(params, batch, capture=False)      — logits, MoE aux loss
                                               (+ FFN captures)
  loss_fn(params, batch)                     — (loss, {"ce", "aux_loss"}):
                                               next-token CE, chunked
  init_cache(batch, max_len, swa=False, n_frames=0)
                                             — contiguous KV cache (int8
                                               when cfg.kv_quant), or with
                                               swa the sliding-window rings;
                                               SSM sublayers' states; an
                                               enc-dec model's DecoderCache
  init_paged_cache(num_pages, page_size)     — paged KV arenas (decoder-only)
  prefill(params, batch, cache, window=0)    — (logits_last, cache)
  decode_step(params, tokens, position, cache, page_tables=None, window=0)
                                             — (logits, cache)

Batch keys: "tokens" [B, S] int (targets are the tokens shifted by one,
weighted by an optional "loss_mask" [B, S]); "patch_feats" [B, P,
d_frontend] (VLM); "frames" [B, F, d_frontend] (encoder-decoder).

Params are nested dicts of tensors on `model.device`: {"embed": {...},
"stack": [per-group {"sub_j": {...}}], "final_norm": {...}} for
decoder-only stacks, plus "projector" {"w1", "w2"} for the VLM;
{"embed", "encoder": {"frontend_proj", "layers": [...], "final_norm"},
"decoder": {"layers": [...], "final_norm"}} for the encoder-decoder. They
are the reference's pytrees with each stacked [G, ...] / [L, ...] scan axis
unstacked into a list (`repro_torch.convert.params_from_numpy` and
`params_to_numpy` convert between the two).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed.dtensor import batch_placed
from repro_torch.models import encdec, transformer
from repro_torch.models.layers import (_normal, apply_activation, apply_norm,
                                       embed_tokens, init_embedding,
                                       init_norm, unembed)

Params = Dict[str, Any]

PAGED_ENCDEC = "paged KV cache covers decoder-only stacks"


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, device=device)[None].expand(B, S)


class Model:
    def __init__(self, cfg: ModelConfig, device: DeviceLike = None):
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
        params: Params = {"embed": init_embedding(generator, cfg)}
        if cfg.is_encdec:
            params["encoder"] = encdec.init_encoder(generator, cfg)
            params["decoder"] = encdec.init_decoder(generator, cfg)
        else:
            params["stack"] = transformer.init_stack(generator, cfg)
            params["final_norm"] = init_norm(cfg, self.device)
        if cfg.family == "vlm":
            d, f, dt = cfg.d_model, cfg.d_frontend, cfg.pdtype()
            params["projector"] = {
                "w1": _normal(generator, (f, d), dt, f ** -0.5),
                "w2": _normal(generator, (d, d), dt, d ** -0.5)}
        return params

    # -- shared pieces ---------------------------------------------------------
    def _embed_inputs(self, params: Params, batch: Dict[str, torch.Tensor]):
        """Token embeddings, after the VLM's projected patch prefix, and
        positions over the whole row (decoder-only stacks)."""
        cfg = self.cfg
        tokens = batch["tokens"]
        B = tokens.shape[0]
        x = embed_tokens(params["embed"], tokens, cfg)
        if cfg.family == "vlm":
            dt = cfg.dtype()
            pf = batch["patch_feats"].to(dt)
            proj = apply_activation(pf @ params["projector"]["w1"].to(dt),
                                    "gelu")
            proj = proj @ params["projector"]["w2"].to(dt)
            x = torch.cat([proj, x], dim=1)
        return (batch_placed(x, like=tokens),
                _positions(B, x.shape[1], tokens.device))

    def _encdec_hidden(self, params: Params, batch: Dict[str, torch.Tensor],
                       window: int = 0) -> torch.Tensor:
        """The decoder's teacher-forced hidden states over the encoder's
        memory of `batch["frames"]` (decoder final norm applied)."""
        cfg = self.cfg
        memory = encdec.encoder_forward(params["encoder"], batch["frames"],
                                        cfg)
        tokens = batch["tokens"]
        B, S = tokens.shape
        x = batch_placed(embed_tokens(params["embed"], tokens, cfg),
                         like=tokens)
        return encdec.decoder_forward(params["decoder"], x,
                                      _positions(B, S, tokens.device), memory,
                                      cfg, window=window)

    # -- forward ---------------------------------------------------------------
    def forward(self, params: Params, batch: Dict[str, torch.Tensor],
                capture_activations: bool = False, window: int = 0):
        cfg = self.cfg
        if cfg.is_encdec:
            h = self._encdec_hidden(params, batch, window=window)
            return {"logits": unembed(params["embed"], h, cfg),
                    "aux_loss": torch.zeros((), dtype=torch.float32,
                                            device=h.device)}
        x, positions = self._embed_inputs(params, batch)
        out = transformer.stack_forward(params["stack"], x, positions, cfg,
                                        window=window,
                                        capture_activations=capture_activations)
        h = apply_norm(params["final_norm"], out.x, cfg)
        if cfg.family == "vlm":           # only text positions give logits
            h = h[:, batch["patch_feats"].shape[1]:]
        res = {"logits": unembed(params["embed"], h, cfg),
               "aux_loss": out.aux_loss, "hidden": h}
        if capture_activations:
            res["ffn_pre_act"] = out.ffn_pre_act
            res["ffn_inputs"] = out.ffn_inputs
        return res

    def _hidden_and_aux(self, params: Params, batch: Dict[str, torch.Tensor]):
        """Final hidden states (before the vocab projection) of the text
        positions and the MoE aux loss: what the chunked CE reads."""
        cfg = self.cfg
        if cfg.is_encdec:
            h = self._encdec_hidden(params, batch)
            return h, torch.zeros((), dtype=torch.float32, device=h.device)
        x, positions = self._embed_inputs(params, batch)
        out = transformer.stack_forward(params["stack"], x, positions, cfg)
        h = apply_norm(params["final_norm"], out.x, cfg)
        if cfg.family == "vlm":
            h = h[:, batch["patch_feats"].shape[1]:]
        return h, out.aux_loss

    CE_CHUNK = 512

    def loss_fn(self, params: Params, batch: Dict[str, torch.Tensor]):
        """Next-token cross-entropy, weighted by `batch["loss_mask"]` (from
        the second position), with the vocab projection run CE_CHUNK
        positions at a time, each chunk rematerialised in the backward pass,
        so the logits held at once are [B, chunk, V]. The max shift is
        detached (the reference's `stop_gradient`) and the target logit is a
        select over the vocab. Adds `router_aux_weight * aux` for MoE.
        Returns (loss, {"ce": loss, "aux_loss": aux})."""
        cfg = self.cfg
        h, aux = self._hidden_and_aux(params, batch)
        tokens = batch["tokens"]
        targets = tokens[:, 1:]
        h = h[:, :-1]
        mask = batch.get("loss_mask")
        mask = (mask[:, 1:] if mask is not None
                else torch.ones(targets.shape, device=h.device)).float()
        B, T, d = h.shape
        chunk = min(self.CE_CHUNK, T)
        embed = params["embed"]

        def chunk_ce(h_c, t_c, m_c):
            logits = unembed(embed, h_c, cfg)                 # [B, chunk, V]
            # the values alone (`amax`): a max with indices over the
            # vocab-sharded logits makes DTensor convert the indices to
            # global ones on some torch versions, a host read
            maxl = torch.amax(logits, dim=-1, keepdim=True).detach().float()
            shifted = logits.float() - maxl
            logz = torch.log(torch.sum(torch.exp(shifted), dim=-1))
            iota = torch.arange(logits.shape[-1], device=logits.device)
            tgt = torch.sum(torch.where(t_c[..., None] == iota, shifted, 0.0),
                            dim=-1)
            return torch.sum((logz - tgt) * m_c)

        remat = torch.is_grad_enabled()
        ce_sum = torch.zeros((), dtype=torch.float32, device=h.device)
        m_sum = torch.zeros((), dtype=torch.float32, device=h.device)
        # the last chunk is short where the reference pads it: its padded
        # positions carry mask 0 and add nothing (and `F.pad` of a DTensor
        # mis-sizes its placements on some torch versions)
        for s in range(0, T, chunk):
            args = (h[:, s:s + chunk], targets[:, s:s + chunk],
                    mask[:, s:s + chunk])
            ce_sum = ce_sum + (torch.utils.checkpoint.checkpoint(
                chunk_ce, *args, use_reentrant=False) if remat
                else chunk_ce(*args))
            m_sum = m_sum + torch.sum(args[2])
        loss = ce_sum / torch.clamp_min(m_sum, 1.0)
        if cfg.moe is not None:
            loss = loss + cfg.moe.router_aux_weight * aux
        return loss, {"ce": loss, "aux_loss": aux}

    # -- serving -------------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int, swa: bool = False,
                   n_frames: int = 0, dtype=None) -> Any:
        """Per-slot caches: contiguous [batch, max_len] KV (int8 when
        `cfg.kv_quant`), or with `swa` float rings of `cfg.sliding_window`
        slots; an SSM sublayer's recurrent state. An encoder-decoder
        model's is an `encdec.DecoderCache` with memory K/V of `n_frames`
        (default `cfg.n_prefix_tokens`) frames."""
        cfg = self.cfg
        if cfg.is_encdec:
            return encdec.init_decoder_cache(
                cfg, batch, max_len, n_frames or cfg.n_prefix_tokens,
                self.device, swa=swa, dtype=dtype)
        return transformer.init_stack_cache(cfg, batch, max_len,
                                            self.device, swa=swa, dtype=dtype)

    def init_paged_cache(self, num_pages: int, page_size: int,
                         dtype=None) -> Any:
        """Paged KV arenas (decoder-only, attention-only stacks; see
        `transformer.init_paged_stack_cache` for the layout and the
        ValueError surface)."""
        if self.cfg.is_encdec:
            raise ValueError(PAGED_ENCDEC)
        return transformer.init_paged_stack_cache(
            self.cfg, num_pages, page_size, self.device, dtype=dtype)

    def prefill(self, params: Params, batch: Dict[str, torch.Tensor],
                cache: Any, window: int = 0) -> Tuple[torch.Tensor, Any]:
        """Dense prefill; fills `cache` in place. Returns ([B, 1, V] logits of
        the last position, cache)."""
        cfg = self.cfg
        if cfg.is_encdec:
            memory = encdec.encoder_forward(params["encoder"],
                                            batch["frames"], cfg)
            tokens = batch["tokens"]
            B, S = tokens.shape
            x = embed_tokens(params["embed"], tokens, cfg)
            h, cache = encdec.decoder_prefill(
                params["decoder"], x, _positions(B, S, tokens.device), memory,
                cache, cfg, window=window)
            return unembed(params["embed"], h[:, -1:], cfg), cache
        x, positions = self._embed_inputs(params, batch)
        h, cache = transformer.stack_prefill(params["stack"], x, positions,
                                             cache, cfg, window=window)
        h = apply_norm(params["final_norm"], h[:, -1:], cfg)
        return unembed(params["embed"], h, cfg), cache

    def decode_step(self, params: Params, tokens: torch.Tensor, position,
                    cache: Any, page_tables: Optional[torch.Tensor] = None,
                    window: int = 0) -> Tuple[torch.Tensor, Any]:
        """tokens: [B, 1]; position: a scalar shared by the batch, or a [B]
        vector of per-slot positions (continuous-batching decode,
        decoder-only stacks; the encoder-decoder takes the shared scalar).
        `page_tables` [B, max_pages] int32 routes a paged cache (from
        `init_paged_cache`; per-slot positions required); `window` is a
        sliding-window cache's attention window (0: `cfg.sliding_window`).
        Updates `cache` in place."""
        cfg = self.cfg
        x = embed_tokens(params["embed"], tokens, cfg)
        if cfg.is_encdec:
            if page_tables is not None:
                raise ValueError(PAGED_ENCDEC)
            h, cache = encdec.decoder_decode_step(params["decoder"], x,
                                                  position, cache, cfg,
                                                  window=window)
        else:
            h, cache = transformer.stack_decode_step(params["stack"], x,
                                                     position, cache, cfg,
                                                     page_tables=page_tables,
                                                     window=window)
            h = apply_norm(params["final_norm"], h, cfg)
        return unembed(params["embed"], h, cfg), cache


def build_model(cfg: ModelConfig, device: DeviceLike = None) -> Model:
    """The model for `cfg` on `device` (default cuda; pass "cpu" to run on
    the CPU)."""
    return Model(cfg, device=device)
