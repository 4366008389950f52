"""Shape-only input stand-ins for every (arch x input-shape) pair: tensors
on the meta device (a shape and a dtype, no values, no allocation), with
the reference's shapes and dtypes (`repro.launch.specs`).

For the VLM the text length is seq_len - n_prefix_tokens, so the total
decoder sequence matches the assigned shape; for audio the frames are the
stub frontend output and tokens run the full assigned seq_len on the
decoder.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import InputShape, ModelConfig

META = torch.device("meta")


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def batch_specs(cfg: ModelConfig, shape: InputShape,
                seq_len: int | None = None) -> Dict[str, torch.Tensor]:
    """Token / feature stand-ins for a full-sequence pass (train or
    prefill)."""
    B = shape.global_batch
    S = seq_len if seq_len is not None else shape.seq_len
    if cfg.family == "vlm":
        return {
            "tokens": _sds((B, S - cfg.n_prefix_tokens), torch.int32),
            "patch_feats": _sds((B, cfg.n_prefix_tokens, cfg.d_frontend),
                                torch.bfloat16),
        }
    if cfg.family == "audio":
        return {
            "tokens": _sds((B, S), torch.int32),
            "frames": _sds((B, cfg.n_prefix_tokens, cfg.d_frontend),
                           torch.bfloat16),
        }
    return {"tokens": _sds((B, S), torch.int32)}


def decode_token_specs(shape: InputShape) -> Dict[str, torch.Tensor]:
    return {"tokens": _sds((shape.global_batch, 1), torch.int32),
            "position": _sds((), torch.int32)}


def uses_swa_for(cfg: ModelConfig, shape: InputShape) -> bool:
    """long_500k decode needs sub-quadratic memory: SWA ring for attention-
    dominated families; SSM/hybrid run natively (states / sparse attn
    layers)."""
    return shape.name == "long_500k" and cfg.family in ("dense", "vlm",
                                                        "audio")


def cache_struct(cfg: ModelConfig, shape: InputShape) -> Any:
    """The decode cache of `shape`'s batch and length in bf16 (the port's
    per-layer lists) of a meta-device model of `cfg`."""
    from repro_torch.models import build_model
    swa = uses_swa_for(cfg, shape)
    return build_model(cfg, device=META).init_cache(
        shape.global_batch, shape.seq_len, swa=swa, dtype=torch.bfloat16)


def params_struct(cfg: ModelConfig) -> Any:
    """The params of `cfg` as meta-device stand-ins (the port's layout:
    per-layer lists), drawn under a `FakeTensorMode`, so a full-size
    model costs no memory."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.distributed.sharding import map_stacked
    from repro_torch.models import build_model
    with FakeTensorMode():
        params = build_model(cfg, device="cpu").init_params(
            torch.Generator().manual_seed(0))
    return map_stacked(lambda _, __, t: _sds(t.shape, t.dtype), params)
