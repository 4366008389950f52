"""The encoder-decoder (seamless-m4t-medium) and VLM (internvl2-26b) models
in the port against the reference, on the reference's weights.

At reduced geometry (2 + 2 layers, d_model 256, vocab 128), with the
reference's params converted into the port (`convert.params_from_numpy`)
and the same seeded numpy tokens, frames and patch features fed to both:

- `forward` logits equal the reference's to 1e-4 of their scale;
- `prefill` + teacher-forced `decode_step` logits equal the reference's
  (1e-4 of their scale), with a contiguous cache and with `swa=True` rings
  of the reduced window (64 slots; 60-token prompts and 10 decode steps,
  so the rings wrap); the ring decode goes through
  `ops.swa_decode_attention` once a layer a step (its plain version here);
- the counterparts of tests/test_encdec_vlm.py on the port's own init
  (encoder bidirectional, decoder causal, VLM prefix shapes and influence,
  VLM loss finite with gradients at the projector, enc-dec prefill +
  decode equal to the teacher-forced forward);
- `params_to_numpy` gives back the reference's tree bit for bit (float32
  and bf16), paged caches are refused for the encoder-decoder, a
  cross-attention block has no q/k/v biases, and `cfg.remat` computes the
  same loss and gradients.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import build_model as jbuild_model
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.kernels import ops
from repro_torch.models import build_model
from repro_torch.models.layers import init_attention
from repro_torch.training.train import grads_of

torch.set_num_threads(1)

ARCHS = ["seamless-m4t-medium", "internvl2-26b"]
SMALL = dict(vocab_size=128)
TOL = 1e-4          # of the logits' scale: float32 sums in another order


def _inputs(cfg, B, S, seed=0):
    """Seeded numpy tokens [B, S] and the family's stub features."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    feats = (B, cfg.n_prefix_tokens, cfg.d_frontend)
    if cfg.family == "vlm":
        batch["patch_feats"] = rng.standard_normal(feats).astype(np.float32)
    if cfg.family == "audio":
        batch["frames"] = rng.standard_normal(feats).astype(np.float32)
    return batch


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _pair(arch, seed=0, **kw):
    """Reference model + params, and the port's model on the CPU with the
    same params."""
    jcfg = jget_config(arch, reduced=True, **SMALL, **kw)
    jmodel = jbuild_model(jcfg)
    tree = jax.tree_util.tree_map(
        np.asarray, jmodel.init_params(jax.random.PRNGKey(seed)))
    cfg = get_config(arch, reduced=True, **SMALL, **kw)
    model = build_model(cfg, device="cpu")
    return (jmodel, jax.tree_util.tree_map(jnp.asarray, tree), model,
            params_from_numpy(tree, cfg, device="cpu"), tree)


def _close(got, want):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=TOL * scale)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match_reference(arch):
    jmodel, jparams, model, params, _ = _pair(arch)
    batch = _inputs(model.cfg, B=2, S=12)
    want = jmodel.forward(jparams, _j(batch))["logits"]
    got = model.forward(params, _t(batch))["logits"]
    assert tuple(got.shape) == tuple(want.shape) == (2, 12, 128)
    _close(got.numpy(), want)


@pytest.mark.parametrize("swa", [False, True], ids=["contiguous", "swa"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_match_reference(arch, swa):
    jmodel, jparams, model, params, _ = _pair(arch, seed=1)
    cfg = model.cfg
    B, P, n = 2, 60, 10
    batch = _inputs(cfg, B, P + n, seed=1)
    toks = batch["tokens"]
    off = cfg.n_prefix_tokens if cfg.family == "vlm" else 0
    max_len = off + P + n
    jcache = jmodel.init_cache(B, max_len, swa=swa)
    cache = model.init_cache(B, max_len, swa=swa)
    prompt = dict(batch, tokens=toks[:, :P])
    jl, jcache = jmodel.prefill(jparams, _j(prompt), jcache)
    lg, cache = model.prefill(params, _t(prompt), cache)
    _close(lg.numpy(), jl)
    ops.reset_counts()
    for i in range(P, P + n):
        tok = toks[:, i:i + 1]
        jl, jcache = jmodel.decode_step(jparams, jnp.asarray(tok),
                                        jnp.int32(off + i), jcache)
        lg, cache = model.decode_step(params, torch.from_numpy(tok), off + i,
                                      cache)
        _close(lg.numpy(), jl)
    n_attn = cfg.n_layers
    swa_calls = ops.counts["swa_decode"].plain_calls
    assert swa_calls == (n * n_attn if swa else 0)
    if swa:     # the rings wrapped: every slot holds a position
        rings = cache.self_kv if cfg.is_encdec else [
            g["sub_0"] for g in cache]
        assert all(int(r.pos.min()) >= 0 for r in rings)


def test_encoder_is_bidirectional():
    """Counterpart of tests/test_encdec_vlm.py:12: perturbing a LATE frame
    changes EARLY decoder outputs (through cross-attention)."""
    model = build_model(get_config(ARCHS[0], reduced=True), device="cpu")
    p = model.init_params(torch.Generator().manual_seed(0))
    batch = _t(_inputs(model.cfg, B=1, S=8))
    out1 = model.forward(p, batch)["logits"]
    b2 = dict(batch, frames=batch["frames"].clone())
    b2["frames"][:, -1] = 5.0
    out2 = model.forward(p, b2)["logits"]
    assert not torch.allclose(out1[:, 0], out2[:, 0], atol=1e-5)


def test_decoder_is_causal_over_tokens():
    """Counterpart of tests/test_encdec_vlm.py:25."""
    model = build_model(get_config(ARCHS[0], reduced=True), device="cpu")
    p = model.init_params(torch.Generator().manual_seed(1))
    batch = _t(_inputs(model.cfg, B=1, S=10))
    out1 = model.forward(p, batch)["logits"]
    b2 = dict(batch, tokens=batch["tokens"].clone())
    b2["tokens"][:, -1] = 0
    out2 = model.forward(p, b2)["logits"]
    torch.testing.assert_close(out1[:, :-1], out2[:, :-1], rtol=1e-5,
                               atol=1e-5)


def test_vlm_prefix_shapes_and_influence():
    """Counterpart of tests/test_encdec_vlm.py:38: logits only for text
    positions, and the patch features reach them."""
    cfg = get_config(ARCHS[1], reduced=True)
    model = build_model(cfg, device="cpu")
    p = model.init_params(torch.Generator().manual_seed(2))
    B, S = 2, 12
    batch = _t(_inputs(cfg, B=B, S=S))
    out = model.forward(p, batch)["logits"]
    assert tuple(out.shape) == (B, S, cfg.vocab_size)
    out2 = model.forward(p, dict(batch,
                                 patch_feats=batch["patch_feats"] * 2.0))
    assert not torch.allclose(out, out2["logits"], atol=1e-5)


def test_vlm_loss_finite_and_differentiable():
    """Counterpart of tests/test_encdec_vlm.py:52: gradients reach the
    projector."""
    cfg = get_config(ARCHS[1], reduced=True)
    model = build_model(cfg, device="cpu")
    p = model.init_params(torch.Generator().manual_seed(3))
    batch = _t(_inputs(cfg, B=2, S=10))
    loss, _ = model.loss_fn(p, batch)
    assert torch.isfinite(loss)
    _, _, g = grads_of(model, p, batch)
    proj_g = float(g["projector"]["w1"].abs().sum())
    assert np.isfinite(proj_g) and proj_g > 0


def test_encdec_prefill_decode_equals_teacher_forced():
    """Counterpart of tests/test_encdec_vlm.py:64."""
    cfg = get_config(ARCHS[0], reduced=True)
    model = build_model(cfg, device="cpu")
    p = model.init_params(torch.Generator().manual_seed(4))
    B, S, P = 2, 14, 10
    batch = _t(_inputs(cfg, B=B, S=S))
    full = model.forward(p, batch)["logits"]
    cache = model.init_cache(B, S + 4, n_frames=cfg.n_prefix_tokens)
    lg, cache = model.prefill(p, dict(batch, tokens=batch["tokens"][:, :P]),
                              cache)
    errs = [float((lg[:, -1] - full[:, P - 1]).abs().max())]
    for i in range(P, S):
        lg, cache = model.decode_step(p, batch["tokens"][:, i:i + 1], i,
                                      cache)
        errs.append(float((lg[:, 0] - full[:, i]).abs().max()))
    scale = max(float(full.abs().max()), 1.0)
    assert max(errs) < 2e-3 * scale


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_params_round_trip_to_reference_layout(arch, dtype):
    """`params_to_numpy` is the inverse of `params_from_numpy`: the
    reference's tree (stacked layers, bf16 as its bits) comes back."""
    kw = dict(param_dtype=dtype, compute_dtype=dtype)
    *_, params, tree = _pair(arch, **kw)
    back = params_to_numpy(params)
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(tree))
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(tree)):
        assert a.shape == b.shape and a.itemsize == b.itemsize
        assert a.tobytes() == b.tobytes()
    cfg = get_config(arch, reduced=True, **SMALL, **kw)
    again = params_from_numpy(back, cfg, device="cpu")
    for a, b in zip(jax.tree_util.tree_leaves(params_to_numpy(again)),
                    jax.tree_util.tree_leaves(back)):
        assert a.tobytes() == b.tobytes()


def test_layer_count_checked_on_load():
    *_, tree = _pair(ARCHS[0])
    cfg = get_config(ARCHS[0], reduced=True, **SMALL, n_enc_layers=3)
    with pytest.raises(ValueError, match="config has 3 encoder layers"):
        params_from_numpy(tree, cfg, device="cpu")


def test_encdec_refuses_paged_caches():
    """The reference's model.py:188-189 and :225-226."""
    model = build_model(get_config(ARCHS[0], reduced=True), device="cpu")
    with pytest.raises(ValueError, match="decoder-only stacks"):
        model.init_paged_cache(4, 16)
    p = model.init_params()
    cache = model.init_cache(1, 8)
    with pytest.raises(ValueError, match="decoder-only stacks"):
        model.decode_step(p, torch.zeros((1, 1), dtype=torch.long), 0, cache,
                          page_tables=torch.zeros((1, 1), dtype=torch.int32))


def test_cross_attention_has_no_biases():
    cfg = dataclasses.replace(get_config("qwen2-7b", reduced=True),
                              qkv_bias=True)
    gen = torch.Generator().manual_seed(0)
    assert "bq" in init_attention(gen, cfg)
    assert not {"bq", "bk", "bv"} & set(init_attention(gen, cfg, cross=True))


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_computes_the_same_loss_and_gradients(arch):
    """`cfg.remat` checkpoints each layer (group) in the backward pass: the
    same function, so the same loss and gradients."""
    *_, params, _ = _pair(arch)
    batch = _t(_inputs(get_config(arch, reduced=True, **SMALL), B=2, S=10))
    out = []
    for remat in (False, True):
        cfg = get_config(arch, reduced=True, **SMALL, remat=remat)
        out.append(grads_of(build_model(cfg, device="cpu"), params, batch))
    torch.testing.assert_close(out[0][0], out[1][0], rtol=0, atol=0)
    for a, b in zip(jax.tree_util.tree_leaves(params_to_numpy(out[0][2])),
                    jax.tree_util.tree_leaves(params_to_numpy(out[1][2]))):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
